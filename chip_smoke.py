"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives gandalf_tpu_torch's main paths on the card, grad-h SPH hydro
only, self-gravitating and with block timesteps, the self-gravitating
meshless finite-volume box, the direct-summation N-body cluster, the
walk's options, the Boss-Bodenheimer collapse with sinks, the 1D and 2D
grid path and mirror walls (the Sod tube, the Kelvin-Helmholtz
instability, the mirror-wall box), block-stepped star formation and
time-dependent viscosity, the gas-dust drag (the dusty box and the
dusty Evrard collapse), Saitoh & Makino (2012) SPH and the external
potentials, RadWS radiative cooling and radiative feedback, the
quintic, gaussian and tabulated smoothing kernels, MFV's options (the
exact Riemann solver, RK2, every slope limiter) and its 1D and 2D grid
path, block-timestep MFV, the radiation schemes (ionisation, treeray
and Monte-Carlo photoionisation of the Spitzer HII region) and block
timesteps on the 1D and 2D grid path, self-gravity in 1D and 2D
(the tree kernels K4-K7 at NDIM 1 and 2, the 2D self-gravitating disc
under global and block steps, the 2D periodic box without the Ewald
sum, MFV gravity in 2D) and sinks in 1D and 2D (K14, K16-K18 and K20
at NDIM 1 and 2, the 2D disc forming and growing sinks under global and
block steps, 2D binary accretion), radiation and radiative feedback in
1D and 2D (K30 and K34-K37 at NDIM 1 and 2, the 2D HII region under each
scheme, the 2D sink disc with radiative feedback), the command line
with its snapshots and restarts, the smoothing-kernel family in MFV and
in cd2010 viscosity, the gas-dust drag and SM2012 (K21, K23-K26) and
in sinks, stars and softened N-body (K14, K16, K20), and the
distributed controller (Nmpi = 4 shards on the one card: K1 with
zrow_max, K2 and K3 on ghosted slabs, ring-LET gravity with K38), and
checks them, in phases, each printing one line:

1. device: the card's name and power limit (nvidia-smi); refuses to run
   without CUDA;
2. build: compiles the CUDA kernels K1-K38 from csrc/ (one nvcc per
   source, in parallel) and the C++ tree planner, prints the times and
   writes ptxas's report of each kernel's registers and spills to
   chiprun_out/ptxas.txt under the working directory;
3. kernels: K1-K3 against their plain PyTorch versions on the card, at
   16^3 and 32^3 particles, in float64 and float32;
4. tree_kernels: K4-K7 the same way on the self-gravitating slice, with
   a forced-overflow case;
5. active_kernels: K8, K9 and the group-list launches of K6 and K7 the
   same way on the block slice's sphere at about 4k and 32k particles,
   for a random eighth of the particles and for all of them;
6. parity: 5 steps of the hydro slice at 16^3 in float64, kernels on the
   card against the plain path on the CPU;
7. tree_parity: 5 steps of the self-gravitating slice at 16^3 in
   float64 with a tree rebuild every 2 steps, the same way;
8. block_parity: 12 ticks of the block slice (cold_sphere_block, 912
   particles) in float64, the same way, with equal active sets and
   levels on every tick;
9. main_path: the hydro slice at 64^3 = 262,144 particles in float32,
   setup, bootstrap and 18 steps through main_loop_steps (16 timed),
   with launch counts, finiteness, overflow and energy checks, and K2's
   and K3's times under both thread mappings (check.mapping_times);
10. gravity_main_path: the self-gravitating slice (bench.build_sim(64))
   at 64^3 in float32: setup, 2 warm-up steps, the post-warm-up replan,
   2 more, then 32 timed steps (one rebuild cadence), with launch
   counts, finiteness, overflow, energy and direct-sum accuracy checks
   (the gate also shown to reject a monopole tree), and each of K1-K7's
   times beside its plain version's at its shapes;
11. block_main_path: the block slice (cold_sphere_block) at about
   262,144 particles in float32: setup, 4 warm-up ticks, 32 timed ticks
   (one rebuild cadence), with rates, the level histogram, launch
   counts, finiteness, overflow, energy and accuracy checks (the gate
   again shown to reject a monopole tree), and each kernel's time beside
   its plain version's at the path's shapes;
12. mfv_kernels: K10-K12 and K7's MFV zeta mode against their plain
   versions on the card on the mfv_box configuration at 16^3 and 32^3,
   in float64 and float32;
13. mfv_parity: 5 steps of mfv_box at 16^3 in float64 with a tree
   rebuild every 2 steps, kernels on the card against the plain path
   on the CPU;
14. mfv_main_path: mfv_box at 64^3 in float32: setup, 2 warm-up steps,
   the post-warm-up replan, 2 more, then 32 timed steps (one rebuild
   cadence) through main_loop_steps, with launch counts, finiteness,
   overflow, exact mass, energy and accuracy (against the all-pairs
   mfv_smoothed_gravity) checks, and each kernel's time beside its
   plain version's at the path's shapes;
15. nbody_kernels: K13-K15 against their plain versions on the card for
   the 2D binary and Plummer clusters of 1,000 and 8,192 stars with one
   coincident pair, in float64 and float32;
16. nbody_parity: 10 float64 steps of a 1,024-star plummer_cluster under
   hermite4 (softened, K14) and hermite6ts (unsoftened, K13 and K15),
   kernels on the card against the plain path on the CPU;
17. nbody_main_path: plummer_cluster (check.nbody_params) at 65,536 stars
   in float64: setup (the IC's seconds reported), bootstrap, 2 warm-up
   steps, then 32 timed steps, with star-steps/s, pair interactions/s,
   simulated time per wall second, launch counts, finiteness and the
   energy drift over the window, and K14's time beside its plain
   version's at the path's shapes;
18. nbody_ts6_path: hermite6ts, unsoftened, at 16,384 stars: 2 warm-up
   and 8 timed steps (K13 and K15 twice a step), with rates, launch
   counts and finiteness, and K13's and K15's times at those shapes;
19. ewald_kernels: K6 and K7 in their Ewald mode against their plain
   versions on the card at 16^3 and 32^3, in float64 and float32: the
   Jeans box (fully periodic), the slab and the cylinder (the sheet and
   line far fields), and the MFV box with the Ewald sum (its zeta mode);
20. tree_option_kernels: K6 with the gadget2 and eigenmac MACs and K6 and
   K7 with the fast monopole and quadrupole the same way on the
   self-gravitating box, each also over a group list;
21. ewald_parity: 3 float64 steps at 16^3 of the Jeans box, the slab,
   the cylinder and the MFV box with the Ewald sum, kernels on the card
   against the plain path on the CPU, with equal tree plans;
22. ewald_main_path: ewald_jeans_box (check.jeans_params) at 64^3 in
   float32: the host table's build time, setup, 2 warm-up steps, the
   post-warm-up replan, 2 more, then 32 timed steps (one rebuild
   cadence), with launch counts, finiteness, overflow replans, the
   energy drift and the accuracy against the periodic direct sum
   (check.periodic_gravity_accuracy; the gate shown to reject the same
   walk without the correction), and each kernel's time beside its
   plain version's at the path's shapes;
23. tree_options_path: the self-gravitating box of gravity_main_path at
   64^3 in float32 with gadget2, eigenmac and fast_quadrupole in turn:
   setup (its bootstrap replans counted), 2 warm-up steps, the
   post-warm-up replan, then 8 timed steps, with rates, launch counts,
   replans, and the accuracy against the direct sum beside the
   geometric MAC's on the same state (an accuracy MAC within 1.001
   times it; the fast quadrupole within 5e-3), and K6's and K7's times
   at the path's shapes;
24. sink_kernels: K16-K18 against their plain versions on the card in
   float64 and float32 on synthetic inputs with the edge cases
   (check.sink_kernel_inputs): 4,096 gas particles with 16 and with 64
   slots, and an embedded cluster's 262,144 gas particles with 4,096
   stars, timed there in float32 beside each kernel's bound;
25. sink_parity: float64 on the card against the plain path on the CPU:
   6 steps of a random Boss-Bodenheimer cloud of 1,000 particles that
   forms a sink each step, and 5 steps of a hybrid Plummer sphere of 512
   gas particles and 16 stars that accretes; equal sinks created at equal
   steps, equal eaten gas and equal tree plans;
26. bb_sink_collapse: GANDALF's bossbodenheimer.dat (check.bb_params)
   at about 262,144 particles in float32 with rho_sink lowered to 2e-17 g
   cm^-3: setup, then 32 timed steps (4 tree rebuilds), with rates,
   sinks formed, launch counts, finiteness over the alive gas, dead gas
   at rest and massless, gas plus sink mass in float64, each step's sink
   gain against the gas that died (check.sink_ledger keeps references
   in the window and sums them after it), overflow and the
   tree plus star-gas accuracy against the float64 all-pairs sum; then
   K4 (with its alive input), K6, K7 and K16-K18 against their plain
   versions at the path's state;
27. bb_published: the same file with only Nhydro, the snapshot times and
   run_id changed, 8 steps: no sink forms, every field finite;
28. dims_kernels: K1-K3 at ndim 1 and 2 against their plain versions on
   the card, on the Sod tube (512 + 128) and the small KHI (32x16 +
   48x24), in float64 and float32;
29. mirror_kernels: K19, K1 with its discard mask and K2/K3 on the
   extended set against their plain versions, for both wall layouts of
   tests/test_grid_mirror.py at 16^3 and its 1D mirror column, in float64
   and float32;
30. dims_parity: 5 float64 steps each of the Sod tube, the small KHI,
   both mirror layouts at 8^3 and the 1D mirror column, kernels on the
   card against the plain path on the CPU, with equal grid plans;
31. khi_main_path: the KHI (check.khi_params) at 425,984 particles in
   float32: setup, 2 warm-up steps, 32 timed steps, with the rate, the
   launch counts, finiteness, overflow, energy drift, the momentum change
   and the density contrast, and K1-K3 (2D) against their plain versions
   at the path's state;
32. khi_published: GANDALF's examples/khi.dat as written, 8 steps;
33. sod_path: the Sod tube (512 + 128) in float64 to t = 0.5, periodic
   and between mirror walls, each with L1(vx) < 9e-3 against the exact
   solution, then examples/adsod.dat as written to its tend;
34. mirror_box: both wall layouts at 64^3 in float32, 2 warm-up and 16
   timed steps, with no particle beyond a wall after each burst, K19
   launched every step, energy drift, finiteness and overflow, and the
   mirror path's kernels against their plain versions;
35. td_sink_kernels: K20 (smooth accretion, both its launches), K21 (the
   Cullen & Dehnen switch) and K22 (the neighbour-level pass) against
   their plain versions on the card in float64 and float32: K20 on
   check.smooth_accretion_inputs at 16 and 64 slots (a particle at equal
   distance from two sinks, dead gas, empty slots, gas going whole and in
   part), timed at the embedded cluster (262,144 gas, 4,096 stars); K21
   on the Sod tube, the small KHI and the box at 16^3 and 32^3 (one
   particle's h shrunk so that its rr is singular and `bad` fires),
   timed at the 64^3 box; K22 on the boxes at 16^3 and 32^3 (random
   levels, 5% dead) and on cold_sphere_block;
36. block_sink_parity: float64 on the card against the plain path on the
   CPU: 6 ticks of the hybrid Plummer sphere of sink_parity (512 gas,
   16 stars) with Nlevels 3, level_diff_max 1, smooth accretion and mm97
   (equal levels, nlast, alive gas, sink masses and tree plans on every
   tick), and 4 global steps of sink_parity's Boss-Bodenheimer cloud
   with cd2010 and smooth accretion;
37. bb_block_collapse: check.bb_block_params at about 262,144 particles
   in float32 (Nlevels 5, level_diff_max 2, smooth accretion, mm97,
   rho_sink 2e-17 g cm^-3): setup, 4 warm-up ticks, 32 timed ticks, with
   ticks/s, alive particle-updates/s, the level histogram, sinks formed,
   the gas left with part of its mass (none here: dt_base stays below
   smooth_accrete_dt times every sink's orbital time, so each claimed
   particle goes whole; `orbit_rule` prints both), gas plus sink mass in
   float64 (within 1e-6), the sink ledger per call, alpha's range,
   launches per tick, finiteness and replans; then K20 and K22 against
   their plain versions at the path's state;
38. khi_cd2010: khi_main_path's KHI with cd2010 in float32, 2 warm-up and
   32 timed steps: the rate beside khi_main_path's, K21 (2D) once a
   step, median alpha below 0.15, finiteness, energy drift, momentum;
39. sod_td_avisc: the Sod tube (256 + 64) in float64 to t = 0.25 with
   mm97, then cd2010, each held to tests/test_adsod.py:111-179's gates;
40. dust_kernels: K23 (the gas-dust drag sums) and K24 (the dust-to-gas
   energy deposit) against their plain versions on the card on
   check.dust_kernel_inputs (per-row dt with tau on both sides of 1e-3, a
   coincident gas-dust pair, 5% dead): at 4,096 particles in 1, 2 and 3
   dims, float64 and float32, every drag law, two-fluid and
   test-particle, the energy term on and off, and both mirror layouts
   of tests/test_grid_mirror.py and the 1D mirror column, each at 4,096
   and at 32,768 particles; timed at 32,768 in 3D in float32;
41. dust_parity: float64 on the card against the plain path on the CPU,
   with equal grid and tree plans: 5 steps of the 1D dusty box periodic
   and between mirror walls, 3 steps of the 1,824-particle dusty Evrard
   cloud with tree gravity, two-fluid then test-particle, and 6 dense
   block ticks of it with Nlevels 3 and equal levels on every tick;
42. dustybox_path: the 1D dusty box of tests/test_dust.py in float64 on
   the grid path, two-fluid to t = 1 (:58-66's gates) and test-particle
   to t = 0.8 (:135-143's), the 2D box at 32^2 between mirror walls
   across y to t = 0.3 (:58-66's gates); then the 3D box at 64^3 gas +
   64^3 dust in float32, 2 warm-up and 16 timed steps, with the rate,
   dv(t)/dv0 against e^-t, the momentum change, K23 and K24 once a step,
   and both kernels against their plain versions at its state;
43. dusty_evrard: check.dust_params at Nhydro 131,072 (about 262,144 gas
   and dust particles) in float32, two-fluid Epstein drag with tree
   gravity: setup, 2 warm-up and 32 timed steps, with the rate, K,
   launches, finiteness, rho > 0 of both types, exact gas and dust mass,
   overflow, the energy drift (kinetic + thermal + potential) and the
   tree's accuracy with the dust's masses, then K23 and K24 against
   their plain versions at the path's state;
44. sm2012_kernels: K25 (the Saitoh & Makino h-rho iteration and q sum)
   and K26 (the pressure-energy forces) against their plain versions on
   the card on check.sm2012_kernel_inputs (a jittered lattice with a u
   jump, 5% dead, a coincident pair in 2 and 3 dims, a full cell) at
   4,096 and 32,768 particles in 1, 2 and 3 dims, float64 and float32,
   alpha fixed and per particle; timed at 32^3 in float32;
45. khi_sm2012: khi_main_path's KHI (425,984 particles, float32) through
   SM2012SphSimulation: setup, 2 warm-up and 32 timed steps, the rate
   beside khi_main_path's, khi_main_path's gates, K1, K25 and K26 (2D)
   every step and no K2 or K3, then K25 and K26 against their plain
   versions at the path's state;
46. sm2012_gravity_box: gravity_main_path's self-gravitating box at 64^3
   through SM2012SphSimulation in float32: 2 + 2 warm-up steps around
   the replan, 32 timed steps, K1, K25, K26 and K4-K7 every step, the
   energy drift and the tree's accuracy, then K25 and K26 against their
   plain versions at the path's state;
47. sm2012_tube: tests/test_sm2012.py's 1D gates in float64 on the grid
   path: the Sod tube (256 + 64, t = 0.25: L1(vx) < 0.03, energy within
   1e-4) and the contact discontinuity (32 + 128, t = 0.5: largest |v|
   below 0.05 and below 0.8 times grad-h SPH's);
48. sm2012_parity: float64 on the card against the plain path on the
   CPU: 5 steps of the self-gravitating box at 16^3 and of the hybrid
   Plummer sphere with 8 accreting stars, through SM2012;
49. extpot_box: the vertical field of tests/test_extpot.py:18-42 on the
   grid path on the card (a_z = avert to 1e-10), and 8 steps of the
   hybrid Plummer sphere with stars in a Plummer field against the plain
   path on the CPU;
50. radws_kernels: K27 (the radws table EOS), K28 (the equilibrium
   finder) and K29 (the implicit heating rate) against their plain
   versions on the card on check.radws_kernel_inputs at 262,144
   elements (both clamps hit), on the ideal table and on
   check.nonideal_table, in float64 and float32 (K27 also on a dense
   (cells, K) shape with empty slots, K28 and K29 with scalar and
   per-element T_amb), with the flips counted; K30 (the radiative-
   feedback ambient temperature) on check.ambient_kernel_inputs at
   262,144 particles with 16 and 4,096 slots, disc heating off, about one
   and two central slots, and sink_heating off; timed in float32;
51. radws_box: gravity_main_path's box at 64^3 on radws (float32, the
   quadrupole tree): 2 warm-up and 32 timed steps, K1-K7, K27 and K28
   every step, the tree's accuracy, T within 10% of temp_ambient; then
   K27-K29 against their plain versions at the path's state;
52. radws_block_box: the same with Nlevels 3 (the compacted tick: K1, K8,
   K9, the group-list K6/K7, K27, K28), 32 timed ticks, the same gates;
53. radfb_cluster: the hybrid Plummer sphere of 262,144 gas particles and
   4 stars on radws with radiative feedback (sink, ambient and disc
   heating), 8 timed steps with K1-K7, K14, K16, K18, K27, K28 and K30
   every step, the mass, T_amb >= temp_ambient; then K30 against its
   plain version at the path's state;
54. radws_mfv_box: mfv_box at 64^3 on radws, 32 timed steps with K1,
   K4-K7 (MFV), K10-K12, K27 and K29 every step, the mass exact, T within
   12% of temp_ambient; then K27-K29 at the path's state;
55. radws_parity: float64 on the card against the plain path on the CPU:
   5 steps of the radws box at 8^3 with gravity, with a global dt and
   Nlevels 3, of the hybrid Plummer sphere (256 gas, 4 stars) with
   radiative feedback and of the radws MFV box at 8^3;
56. kernel_family_kernels: K2 and K3 (1-3 dims), K7 (3D, tree gravity)
   and K8, K9 with the group-list K6/K7 (3D) with the quintic, the
   gaussian (no K7: fault F23), the tabulated M4 and the tabulated
   quintic against their plain versions on the card
   (check.compare_family_kernels: the Sod tube, the small KHI, the 16^3
   box, the 2,000-particle block sphere), float64 and float32, with the
   tabulated kernels' pairs near a table point counted;
57. family_parity: float64 on the card against the plain path on the
   CPU with equal grid and tree plans: 3 steps of the 8^3 box with each
   variant (tree gravity but with the gaussian) and 3 ticks of the block
   sphere (1,000) with the quintic, with equal levels;
58. quintic_gravity_box: gravity_main_path's box at 64^3 in float32
   with the quintic: 2 + 2 warm-up steps around the replan, 32 timed
   steps, K2, K3 and K7 (quintic) every step and no M4 K2, K3 or K7,
   the energy drift (1e-2) and the tree's accuracy against the float64
   all-pairs sum with the quintic softening (2e-4), the rate beside
   gravity_main_path's; then K2, K3 and K7 against their plain versions
   at the path's state;
59. tabulated_gravity_box: the same with the tabulated M4 (the
   reference's default), 32 timed steps, then the tabulated quintic, 8
   timed steps, the same gates;
60. gaussian_box: main_path's hydro-only box at 64^3 with the gaussian,
   16 timed steps, the energy drift below 1e-3;
61. gaussian_soundwave: tests/test_soundwave.py:14-32's wave (1D, 64
   particles, isothermal, the gaussian, one period to t = 2) on the grid
   path in float64: L1(rho) < 1e-4, test_soundwave_sph's gate;
62. quintic_block: block_main_path's cold sphere (the same IC) with the
   quintic: 4 warm-up and 16 timed ticks (half the M4 run's: at the
   end of 32 its K is 1,351 and the plain versions it is held against
   take 3 s a call) through K8, K9 and the list
   K6/K7 (quintic) and no M4 K8, K9 or K7, the block gates but the
   energy drift's (2e-2: the JAX package's quintic zeta term is wrong,
   ROADMAP fault F24); then K8, K9 and the list K7 against their plain
   versions at the path's state;
63. mfv_option_kernels: K10-K12 at ndim 1 and 2, K12 in 32 modes (HLLC
   and exact; the Gizmo clamp, the cell alphas, null and zeroslope; MUSCL
   and RK2; moving and static) and K31 (tvdscalar, springel2009) at ndim
   1-3 against their plain versions on the card, in float64 and float32,
   on the MFV Sod tube, the 2D box of tests/test_mfv_grid.py and mfv_box
   at 16^3 (K11's alpha compared where the gradient is above rounding,
   ROADMAP fault F25);
64. mfv_dims_parity: check.MFV_PARITY_CASES (the tube in four option
   sets, the 2D box in two, the Gresho vortex, the isothermal sound
   wave), 5 float64 steps each, kernels on the card against the plain
   path on the CPU, with equal grid plans;
65. mfv_sod_tube: the MFV Sod tube (512 + 128) in float64 to t = 0.5:
   L1(vx) < 7e-3 with MUSCL/HLLC/Gizmo and with mfvrk (the reference's
   AdSodMeshlessTest gate), the exact solver with tvdscalar equal to the
   CPU plain path's L1 (check.MFV_EXACT_TUBE_L1); then the seven limiter
   names at 128 + 32 to t = 0.1, finite with vx.max() > 0.3;
66. mfv_soundwave: tests/test_soundwave.py's MFV wave on the grid path in
   float64, L1(rho) < 2e-3;
67. gresho_mfv: the Gresho vortex at 32^2 through MFV in float64 to t =
   0.3, L1(v_phi) < 0.12;
68. mfv_khi: the 2D box of tests/test_mfv_grid.py at x16 per axis
   (524,288 particles) in float32, 32 timed steps with HLLC and the Gizmo
   limiter, then 16 with the exact solver and tvdscalar: rates, mass
   exact, energy drift within 2e-3, min rho < 1.3 and max rho > 1.6, the
   kernels against their plain versions (K12 also under RK2) and under
   both thread mappings;
69. mfvrk_box and 70. mfv_exact_box: mfv_box (64^3, the quadrupole tree)
   under mfvrk, and with the exact solver and springel2009, 32 timed
   steps each under mfv_main_path's gates;
71. mfv_block_kernels: K12's block mode, K22 (1-3 dims), K32 and K33
   against their plain versions on the card in float64 and float32 after
   3 conservative ticks of the block tube, the 2D box and mfv_box at
   16^3 with the tree (check.compare_mfv_block_kernels);
72. mfv_block_parity: the 2D box (32^2 + 32^2, jittered) with Nlevels 3
   under each time_step_limiter, 5 float64 ticks, kernels on the card
   against the plain path on the CPU, equal levels and schedules;
73. mfv_block_tube: tests/test_mfv_block.py's Sod tube (256 + 64, open
   ends, float64) to t = 0.1 with a global dt and with Nlevels 3: two
   levels occupied, the masses equal to 1e-13, L1(v) < 2e-3 and L1(rho)
   < 1e-3 of block against global;
74. mfv_block_khi: the 2D box at 524,288 particles with Nlevels 3, 32
   timed ticks under simple, then 16 under conservative (finite, mass
   exact, sum Q_E within 5e-2, level_max >= 1; the conservative bound
   at 2,048 sampled particles at or above the float64 all-pairs oracle,
   median ratio < 10), with ticks/s, particle-updates/s and the level
   histogram;
75. mfv_block_sphere: cold_sphere_block's sphere (258,135 particles,
   Nlevels 4, the quadrupole tree, conservative) through block MFV, 32
   timed ticks: mfv_main_path's gates (the tree's accuracy with
   block_main_path's bound for this sphere), the bound against its
   oracle, rates and levels;
76. radiation_kernels: K34-K37 against their plain versions on the card
   at the Spitzer HII region's shapes (258,135 particles in float32, K36
   with the first Monte-Carlo iteration's 2,065,080 packets (8 N) and 256
   steps, K37 also on three overlapping sources), and in float64 at 739
   particles; flags counted against K37's rounding band;
77. radiation_parity: the CPU parity configurations of
   tests/test_torch_radiation_sim.py on the card in float64 against the
   plain path on the CPU, 3 steps each of ionisation, treeray,
   monoionisation (the draws made on the host) and block ionisation;
78-80. spitzer_ionisation, spitzer_treeray and spitzer_mcrt: the Spitzer
   HII region at 258,135 particles in float32, 4 steps each with its
   radiation update: the first update's front within 0.08 (ionisation)
   and 0.1 (treeray) of Rs = 0.35, the ionised volume's radius within
   15% of Rs under monoionisation (cross-section 3,000, an optically
   thick front, and 10 iterations), finite u and 0 <= ionfrac <= 1, with particle-steps/s
   and one update's device ms;
81. active_kernels (ndim 1 and 2): K8 and K9 at NDIM 1 and 2 against
   their plain versions on the card on the block Sod tube's state in
   float64 and the KHI's (x4 per axis, Nlevels 3) in float64 and
   float32, for a random eighth of the particles and for all of them;
82. block_dims_parity: 8 compacted ticks each of the block Sod tube and
   the small KHI (Nlevels 3) in float64, kernels on the card against the
   plain path on the CPU, with equal listed rows, levels and grid plans;
83. block_sod_tube: tests/test_block.py's tube (256 + 64, Nlevels 4) in
   float64 to t = 0.25 (L1(vx) < 0.02, two levels, listed rows below 0.8
   of N ticks), and Nlevels 3 against a global run to t = 0.2 (median
   |drho|/rho < 5e-3, max < 0.08), then K8 and K9 (1D) against their
   plain versions at the tube's end;
84. block_khi_2d: the KHI at 425,984 particles with Nlevels 3 in float32,
   4 warm-up and 32 timed compacted ticks: ticks/s, active
   particle-updates/s, the level histogram, the listed-row fraction, K8
   and K9 launches a tick, finite, rho > 0, no overflow, mass exact,
   energy drift within 2e-3; then K8 and K9 (2D) against their plain
   versions at the path's state;
85. sedov_block_2d: the 2D Sedov blast (check.sedov_params) at 512^2 =
   262,144 particles with Nlevels 5 in float32, 2 warm-up and 32 timed
   ticks: the same figures and the energy drift, at least two levels,
   listed rows below 0.8 of N ticks, finite, rho > 0, mass exact;
86. dustybox_block: tests/test_dust.py:112-133's dusty box (1D, Nlevels
   3, the dense dust tick) in float64 to t = 1, held to its gates;
87. tree_kernels_dims: K4-K7 at NDIM 1 and 2 against their plain
   versions on the card in float64 (K4 exact, K5 within 1e-12, K6 and
   K7 within 1e-10; check.compare_tree_kernels_dims) on the disc and
   the rod of check.disc_params at about 4,096 particles, in every walk
   option (the geometric quadrupole walk and its list launches,
   gadget2, eigenmac, the fast quadrupole, the quintic kernel, K7's MFV
   zeta mode), with ms a launch, plain ms and the bound of each;
88. gravity_disc_2d: the 2D self-gravitating disc (check.disc_params at
   262,144 particles, the quadrupole tree, float32, global dt): 2
   warm-up and 32 timed steps, particle-steps/s and device ms a step
   by kernel, finite, rho > 0, every kernel each step, energy drift
   within 1e-2, the tree at 2,048 sampled particles against the float64
   all-pairs sum within twice the JAX package's reading; then K1-K7
   (2D) against their plain versions at the path's state;
89. gravity_block_disc_2d: the same disc under Nlevels 4 on the
   compacted tick (the list K6/K7), 4 warm-up and 32 timed ticks:
   ticks/s, active particle-updates/s, the levels, the block gates
   (drift within 2e-3, the accuracy gate in the 3D block gate's ratio to
   the JAX error); then K8, K9 and the list K6/K7 (2D) at its state;
90. gravity_box_2d: the 2D periodic box at 256^2 with ewald = 0 (K4's
   per-bucket unwrap along both axes), 16 steps, then K4-K7 (2D) at its
   state;
91. mfv_gravity_disc_2d: the 2D disc at about 65,536 particles through
   MUSCL MFV with self-gravity, 16 steps, mass exact, K7's MFV mode
   (2D) every step;
92. gravity_dims_parity: float64 on the card against the plain path on
   the CPU, 8 steps each of the 2D disc at about 2,000 particles under
   a global dt and under Nlevels 4 and of the 1D rod at 4,096, with
   equal tree plans, levels and listed rows; then K4-K7 (1D) against
   their plain versions at the rod's state on the card;
93. sink_kernels_dims: K14 (1D), K16, K17, K18 and K20 (both launches)
   at NDIM 1 and 2 against their plain versions on the card on
   check.sink_kernel_inputs at 4,096 gas with 16 and 64 slots, float64
   and float32 (K17's row and index, K18's eaten mask and K20's claims
   exactly; float64 sums within 1e-10), timed at 64 slots in float32;
94. sink_disc_2d: gravity_disc_2d's disc (262,376 particles, float32)
   with creation and plain accretion, rho_sink at 0.999 of the
   bootstrap's largest rho (check.sink_disc_sim): 32 timed steps, at
   least 8 sinks, alive fields finite, rho > 0, dead gas at rest and
   massless, gas plus sink mass within 1e-6, the ledger within 1e-5,
   no overflow, each sink kernel once a step, the tree within 1.46e-3;
   then K4 (alive mode), K6, K7, K14, K16-K18 (2D) against their plain
   versions at the path's state;
95. sink_block_disc_2d: the same disc under Nlevels 4 with smooth
   accretion, 4 warm-up and 32 timed dense ticks, the same gates (the
   tree within 1.13e-3, K20 twice a tick), the levels and the spin
   ledger's z range; then K20 (2D) against its plain version;
96. binaryacc_2d: the binaryacc IC at 2 x 256 x 512 (262,144 gas, two
   stars, periodic, no self-gravity) in float64, 32 steps: finite, the
   ledger, mass conserved, both stars active and finite;
97. sink_dims_parity: float64 on the card against the plain path on the
   CPU, 8 steps each of the 2D disc (384) with creation and plain
   accretion, the same with Nlevels 4 and smooth accretion, the 1D rod
   (64) with smooth and with plain accretion, binaryacc at 2 x 16 x 32:
   fields and sinks within 1e-9, equal sinks, eaten gas, levels and
   plans every step; then K14, K16-K18 and K20 (1D) against their plain
   versions at the rods' states on the card;
98. radiation_kernels_dims: K30 and K34-K37 at NDIM 2 and 1 against
   their plain versions on the card, float64 within 1e-12 with K37's
   flags equal (the HII disc of 4,096 and the rod of 1,024 particles, K30
   at 64 slots), then float32 at the disc of 262,144 and the rod of
   65,536 particles, timed beside the bounds;
99-101. hii_region_2d_ionisation, _treeray, _mcrt: the 2D HII region
   (check.hii_ic, 262,376 particles, float32), 4 steps each with its
   update: the front within 0.08 (0.1 treeray) of Rs, the Monte-Carlo
   area radius within 20%, finite u, 0 <= ionfrac <= 1, the 2D kernels
   every step, particle-steps/s and one update's device ms;
102. radfb_disc_2d: the 2D sink disc (262,376) on radws with radiative
   feedback, 16 steps: T_amb finite and >= T_inf, K30 (2D) every step
   and against its plain version;
103. radiation_dims_parity: float64 on the card against the CPU path,
   each scheme on the HII disc and rod, SM2012 with ionisation, radiative
   feedback on the 2D sink disc and the 1D rod with a star: equal ionfrac,
   fields within 1e-9; the 1D radiation kernels counted there;
104. cli_restart: python -m gandalf_tpu_torch in a subprocess on a 2D
   radiating parameter file (16,384 particles, two stars as sources):
   to tend, stopped by Nstepsmax, restarted with -r at the stopped t
   (rel 1e-10) to tend with finite fields, the end against the
   uninterrupted run's.
105. mfv_family_kernels: K10, K11 (with extrema), K31, K12 (HLLC,
    exact, RK2, the cell alphas, zeroslope and its block mode), K7's MFV
    mode (3D, not the gaussian) and the block pass's K22, K32, K33 with
    the quintic, the gaussian and the tabulated M4, quintic and gaussian
    at ndim 1-3 against their plain versions, float64 and float32
    (check.compare_mfv_family_kernels);
106. mfv_family_parity: float64 on the card against the CPU path with
    equal plans: mfv_box at 8^3 with each variant (the tree but with the
    gaussian), a 2D Nlevels 3 box with the tabulated M4 (equal levels),
    the 1D mfvrk exact tube with the quintic;
107. mfv_quintic_box: mfv_box at 64^3 (262,144, float32) with the
    quintic and the tree: K7's MFV mode and K10-K12 with the quintic
    every step, mfv_main_path's gates;
108. mfv_family_block: mfv_block_sphere's run with the tabulated quintic
    (its energy gate F24's, as quintic_block's) and mfv_khi's first run
    (524,288) with the gaussian, K31 (tvdscalar) with the gaussian timed
    at its state;
109. grid_family_kernels: K21, K23 (each drag law two-fluid, and
    test-particle), K24, K25 and K26 with the quintic, the gaussian and
    the tabulated M4, quintic and gaussian at ndim 1-3 against their plain
    versions on the card (check.compare_grid_family_kernels: K21 at a
    cd2010 run's state, the others on synthetic inputs), float64 within
    1e-12 and float32 within check.py's tolerances, the tabulated
    kernels' pairs near a table point counted;
110. grid_family_parity: float64 on the card against the CPU path with
    equal plans: 3 steps of sod_td_avisc's cd2010 tube with the quintic,
    the 1D dusty box with the gaussian and with the tabulated quintic
    under a global dt and under Nlevels 3 (equal levels), the SM2012 tube
    with the tabulated M4 and 3 steps of the SM2012 8^3 box with
    self-gravity and the quintic;
111. family_khi_2d: khi_main_path's KHI (425,984 particles, float32)
    through SM2012 with the quintic and through grad-h cd2010 with the
    gaussian, 2 warm-up and 16 timed steps each, khi_sm2012's and
    khi_cd2010's gates, each family key launched every step and no M4
    key, the rates beside the M4 runs';
112. dusty_evrard_tab: dusty_evrard (check.dust_params(131072)) with the
    tabulated M4, 8 timed steps, dusty_evrard's gates, K23 and K24 under
    their _m4_tab keys every step;
113. sink_family_kernels: K14 (with and without the jerk), K16 and K20
    with the tabulated M4, the quintic and the tabulated quintic at ndim
    1-3 against their plain versions on the card
    (check.compare_sink_family_kernels: 4,096 gas with 16 and with 64
    slots, pairs either side of kernrange and of table points, K14 on
    the gas as stars and on a Plummer cluster), float64 within 1e-12 and
    float32 within check.py's tolerances; K16 and K20 timed at the
    embedded cluster (262,144 gas, 4,096 slots, float32) and K14 at
    65,536 Plummer stars (float64) with each variant; the gaussian,
    direct and tabulated, refused by the three wrappers (fault F23);
114. sink_family_parity: float64 on the card against the CPU path: the
    random Boss-Bodenheimer cloud (1,000, 6 steps) with the tabulated
    M4, the hybrid Plummer sphere (512 + 16 stars) with the tabulated
    quintic, the 2D sink disc (384, Nlevels 3, smooth accretion, 8
    ticks) with the quintic and softened hermite4 plummer_cluster
    (1,024 stars, 10 steps) with the tabulated M4: equal sinks, eaten
    gas, plans and levels, every field within 1e-9;
115. bb_sink_collapse_tab: bb_sink_collapse at full width (258,135 live
    particles, float32, 32 timed steps) with the tabulated M4: its gates
    and no launch under an M4 key of K2, K3, K7, K14 or K16;
116. sink_block_disc_2d_quintic: sink_block_disc_2d at full width with
    the quintic: its gates, no M4 launch, and the energy drift of the gas
    and the slots within 2e-2 (fault F24, as quintic_block's); K14, K16
    and K20 at 2D with the quintic compared at its state;
117. plummer_cluster_tab: nbody_main_path (65,536 stars, float64,
    hermite4, softened) with the tabulated M4, its energy gate.
118. dist_kernels: the distributed controller's kernels against their
    plain versions on the card, float64, at the 16^3 box's 4-shard state
    (all shards on one card): K1 with zrow_max (exact), K2 and K3 on the
    ghosted slabs (qz 1, and qz 2 from a plan for twice the largest h)
    and K38 (the ring radius set to 1, so that one shard is far);
119. dist_parity: 3 float64 steps of the 16^3 box over 4 shards on the
    card against the same shards on the CPU, hydro and LET gravity, the
    decomposition rebuilt after step 2; and hydro over 1 shard against 4
    on the card at the JAX package's gates;
120. dist_main_path: the self-gravitating 64^3 box (262,144 particles,
    float32) over Nmpi = 4 shards on one card: setup, 2 warm-up steps,
    32 timed steps with one rebuild cadence (a host replan), the rate
    beside the single-device gravity path's, the energy drift, gpot
    against the float64 direct sum at 2,048 particles (the JAX package's
    distributed gates, the single-device figure beside it), the launches
    of K1 with zrow_max, K2 and K3 on slabs and K38 per step, the bytes
    the halos and the other collectives hand between shards per step,
    and each of the four kernels' times beside its plain version's.

The line before the last is {"kernels": [...]}: K1-K7 with launch
counts from the self-gravitating main path (K4 also with its alive mode
on the sink path), K8, K9 and the list
launches of K6 and K7 with counts from the block main path, K10-K12
and K7's MFV launches from the MFV main path, K14 from the N-body main
path and K13 and K15 from the hermite6ts path, the Ewald modes of K6
and K7 from the Ewald main path, the gadget2, eigenmac and fast modes
from the options path, K16-K18 from the sink path, the 2D K1-K3 from
khi_main_path, the 1D ones from sod_path's periodic run and K19 from
mirror_box's dim-0 layout, K20 and K22 from bb_block_collapse, K21 in
2D from khi_cd2010, in 1D from sod_td_avisc's cd2010 run and in 3D from
block_sink_parity's Boss-Bodenheimer run on the card (timed at the 64^3
box in phase 35), K23 and K24 from dusty_evrard, K25 and K26 in 2D from
khi_sm2012, in 3D from sm2012_gravity_box and in 1D from sm2012_tube's
Sod run (float64), K27 and K28 from radws_box, K29 from radws_mfv_box
and K30 from radfb_cluster, and the kernel variants (K2, K3 and K7
quintic from quintic_gravity_box, tabulated M4 and tabulated quintic
from tabulated_gravity_box, K2 and K3 gaussian from gaussian_box and in
1D from gaussian_soundwave (float64), K8, K9 and the list K7 quintic
from quintic_block), K10-K12 in 2D from mfv_khi (K12's exact cell-alpha
mode and K31 tvdscalar from its second run) and in 1D from mfv_sod_tube
(float64: K12 RK2 from the mfvrk tube, exact cell-alpha and K31
tvdscalar from the exact tube, the cell-alpha and zeroslope modes and K31
springel2009 from the limiter names), K12 RK2 from mfvrk_box, K12 exact
cell-alpha and K31 springel2009 from mfv_exact_box), K12's block mode in
3D from mfv_block_sphere, in 2D from mfv_block_khi and in 1D from
mfv_block_tube (float64), K22 in 2D from mfv_block_khi and in 1D from
mfv_block_tube, K32 and K33 in 3D from mfv_block_sphere and in 2D from
mfv_block_khi's conservative run, K37 from spitzer_ionisation, K35
from spitzer_treeray, K34 and K36 from spitzer_mcrt, K8 and K9 in 2D
from block_khi_2d and in 1D from block_sod_tube (float64), K4-K7 in 2D
from gravity_disc_2d, the list K6 and K7 in 2D from
gravity_block_disc_2d, K7's MFV mode in 2D from mfv_gravity_disc_2d,
K4-K7 in 1D from gravity_dims_parity's rod on the card (float64), K14,
K16-K18 in 2D from sink_disc_2d (K4's entry there with its alive
mode too), K20 in 2D from sink_block_disc_2d and K14, K16, K17, K20 in
1D from sink_dims_parity's smooth rod and K18 in 1D from its plain rod
(float64), K37, K34 and K35, K34 and K36 in 2D from the hii_region_2d
phases, K30 in 2D from radfb_disc_2d and K30, K34-K37 in 1D from
radiation_dims_parity's rods on the card (float64; times from
radiation_kernels_dims' float32 runs), K7's MFV mode and K10-K12 with
the quintic from mfv_quintic_box, with the tabulated quintic (K12's
block mode) from mfv_family_block's sphere and in 2D with the gaussian
from its KHI, K25 and K26 in 2D with the quintic and K21 in 2D with the
gaussian from family_khi_2d, K23 and K24 with the tabulated M4 from
dusty_evrard_tab, K16 with the tabulated M4 from bb_sink_collapse_tab
and K14 with it from plummer_cluster_tab (their times from
sink_family_kernels' rows at those shapes), K14, K16 and K20 in 2D with
the quintic from sink_block_disc_2d_quintic, K1 with zrow_max, K2 and
K3 on slabs and K38 from dist_main_path, each counted
over its path's timed window (the tubes' over their whole block runs)
(the counts are set to 0 just before it); each
with its bound in its path's dtype (the least time the card could take
for the work, check.bound) and library_ms null where no single PyTorch
call computes the function (K17's is torch.argmax over the masked
score).  The last line is {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero without printing the last line.  Run from the
repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_MAIN = 64
STEPS_WARM = 2
STEPS_TIMED = 16
PARITY_STEPS = 5
PARITY_TOL = 1e-9
ENERGY_DRIFT_TOL = 1e-3
# the self-gravitating main path: one rebuild cadence of bench.py
GRAVITY_STEPS_TIMED = 32
GRAVITY_NTB_PARITY = 2
# gates of the self-gravitating path: rms|da|/rms|a| of the tree against
# the direct sum, and the drift of E = sum m(v^2/2 + u) - sum m gpot / 2
# over the timed window.  The JAX package's own values at 16^3 in
# float64 (tests/test_torch_tree_sim.py) are 5.2e-5 and 1.0e-4 over 10
# steps.  The accuracy read 5.5e-5 on the card at 64^3 in float32: the
# gate is about 3.6 times that, and the phase shows that a monopole tree
# (the quadrupole terms dropped) reads above it.  The energy gate stays
# at the stated 1e-2.
ACCURACY_TOL = 2e-4
GRAVITY_ENERGY_DRIFT_TOL = 1e-2
# the block slice: cold_sphere_block at about 262,144 particles, one
# rebuild cadence of ticks after a short warm-up
BLOCK_N = 262144
BLOCK_TICKS_WARM = 4
BLOCK_TICKS_TIMED = 32
BLOCK_PARITY_N = 1000
BLOCK_PARITY_TICKS = 12
ACTIVE_SIZES = (4000, 32000)
# gates of the block path.  The JAX package's tree on this sphere at 4224
# particles in float64 (tests/test_torch_active_grid.py) reads 3.9e-4
# with the quadrupole and 1.8e-3 as a monopole; a uniform sphere's edge
# makes it larger than the box's 5e-5 (its 912-particle run in
# tests/test_torch_block_sim.py opens every cell and bounds nothing).
# The card read 2.8e-4 for the sampled active particles at about 262,144
# particles in float32: the gate is about twice that, and the phase
# shows that a monopole tree reads above it.  The JAX package's energy
# drift over the 12 ticks of its 912-particle run is 1.2e-3; the gate
# is that with room for float32.
BLOCK_ACCURACY_TOL = 6e-4
BLOCK_ENERGY_DRIFT_TOL = 2e-3
# the MFV box (check.mfv_params): the same tree and accuracy gate as the
# SPH box.  E = sum Q_E - sum m gpot / 2 is not conserved exactly by the
# scheme: the JAX package's own drift over steps 1-5 at 8^3 in float64 is
# 9.1e-4 (tests/test_torch_mfv_sim.py, which holds it below this gate).
# The gate is 2e-3 over the 32 timed steps at 64^3, room for float32.
MFV_STEPS_TIMED = 32
MFV_ENERGY_DRIFT_TOL = 2e-3
# the N-body cluster (check.nbody_params, plummer_cluster) in float64.
# The JAX package's drift of E = sum m v^2/2 - sum m gpot/2 over 32 steps
# at 1,024 stars is 1.9e-9 (tests/test_torch_nbody_sim.py, which holds it
# below a twentieth of this gate); the gate is 1e-7.
NBODY_N = 65536
NBODY_STEPS_WARM = 2
NBODY_STEPS_TIMED = 32
NBODY_ENERGY_DRIFT_TOL = 1e-7
NBODY_KERNEL_SIZES = (2, 1000, 8192)
NBODY_PARITY_N = 1024
NBODY_PARITY_STEPS = 10
NBODY_TS6_N = 16384
NBODY_TS6_STEPS_TIMED = 8
# the periodic self-gravity slice: ewald_jeans_box (check.jeans_params)
EWALD_SIZES = (16, 32)
EWALD_PARITY_N = 16
# 3 steps, a rebuild after the second (PARITY_STEPS, 5, until PR 24: the
# CPU path's Ewald walk took the phase to 116 s on a slow host)
EWALD_PARITY_STEPS = 3
EWALD_STEPS_TIMED = 32
# the gate of the periodic tree's rms|da|/rms|a| against the periodic
# direct sum (min-imaged, kernel-softened, each pair's Ewald correction
# added; check.periodic_gravity_accuracy).  The walk corrects an accepted
# cell at its centre of mass only, and the sine mode's net force (rms
# 0.032) is a residual of far larger terms: the JAX package reads 0.194
# at 32^3 in float64 (tests/test_torch_ewald_sim.py, slow-marked) and
# the card 0.245 at 64^3 in float32; the gate is about twice the larger.
# The same walk without the correction reads 60 (an isolated cube's
# field), which the phase shows the gate rejects.
EWALD_ACCURACY_TOL = 0.5
# the options path: the gravity box with each option, 8 timed steps
OPTIONS = (("gravity_mac", "gadget2"), ("gravity_mac", "eigenmac"),
           ("multipole", "fast_quadrupole"))
OPTIONS_STEPS_TIMED = 8
# tests/test_treeerror.py:145-150 and :62-69: an accuracy MAC opens at
# least the geometric MAC's cells, so its error is at most 1.001 times
# the geometric MAC's; the fast quadrupole's error is at most 5e-3
MAC_ERROR_RATIO = 1.001
FAST_ACCURACY_TOL = 5e-3
# the sink slice: bb_sink_collapse (check.bb_params), rho_sink in g cm^-3
BB_N = 262144
BB_RHO_SINK = 2.0e-17
BB_STEPS_TIMED = 32
BB_PUBLISHED_STEPS = 8
BB_MIN_SINKS = 8
# gas plus sink mass over the window, summed in float64 on the host; and
# each step's sink gain in mass and momentum against what the gas that
# died carried (float32 roundoff of a sink's mass and velocity update)
BB_MASS_TOL = 1e-6
BB_LEDGER_TOL = 1e-5
# the tree (monopole, theta^2 = 0.15) plus star-gas pull against the
# float64 all-pairs sum over the alive gas plus the float64 star-gas sum.
# The JAX package reads 2.09e-3 on this cloud at 2,176 particles after a
# step, in float64 on the CPU (tests/test_torch_sinks.py), and the card
# 2.93e-3 at about 262,144 after the window; the gate is about twice the
# larger.
BB_ACCURACY_TOL = 6e-3
SINK_KERNEL_SIZES = ((4096, 16), (4096, 64))
SINK_CLUSTER = (262144, 4096)
SINK_PARITY_BB_N = 1000
SINK_PARITY_BB_STEPS = 6
SINK_PARITY_PLUMMER = (512, 16)
SINK_PARITY_PLUMMER_STEPS = 5
# the 1D and 2D grid path and mirror walls
KHI_SCALE = 16
KHI_STEPS_WARM = 2
KHI_STEPS_TIMED = 32
KHI_PUBLISHED_STEPS = 8
# tests/test_adsod.py's gate, and tests/test_grid_path.py's on the grid
SOD_L1_GATE = 9e-3
MIRROR_N = 64
MIRROR_KERNEL_N = 16
MIRROR_PARITY_N = 8
MIRROR_STEPS_WARM = 2
MIRROR_STEPS_TIMED = 16
# block-stepped star formation and time-dependent viscosity
TD_SMOOTH_SIZES = ((4096, 16), (4096, 64))
TD_CLUSTER = (262144, 4096)
TD_BOX_SIDES = (16, 32)
# 12 and 6 until PR 24 (as DUST_PARITY_*)
BLOCK_SINK_PARITY_TICKS = 6
BB_CD_PARITY_STEPS = 4
BB_BLOCK_TICKS_WARM = 4
BB_BLOCK_TICKS_TIMED = 32
KHI_CD_STEPS_WARM = 2
KHI_CD_STEPS_TIMED = 32
# tests/test_adsod.py:111-179: alpha starts at alpha_visc_min, its
# largest value passes 0.2 (mm97) or 0.25 (cd2010) at the shock, its
# median stays below 0.15, and L1(vx) < 0.02 at t = 0.25
TD_SOD = (256, 64, 0.25)
TD_ALPHA_MAX = {"mm97": 0.2, "cd2010": 0.25}
TD_ALPHA_MEDIAN = 0.15
TD_SOD_L1 = 0.02
# the gas-dust drag (K23, K24)
DUST_KERNEL_SIZES = (4096, 32768)
DUST_LAWS = (("fixed", 2.0), ("density", 1.0), ("epstein", 1.5),
             ("lp12", 3.0))
# the parity runs' depth: 10, 5 and 12 until PR 24 (the CPU path's
# seconds on a slow host took the script past its time limit)
DUST_PARITY_BOX_STEPS = 5
DUST_PARITY_EVRARD = 1000
DUST_PARITY_STEPS = 3
DUST_PARITY_TICKS = 6
# tests/test_dust.py:58-66 (two-fluid, t = 1: each species' mean v_x
# within 2e-3 of the analytic relaxation, momentum within 1e-12, energy
# within 1e-5) and :135-143 (test particles, t = 0.8: gas within 1e-3 of
# rest, dust within 3e-3 of e^-t)
DUSTYBOX_GATE = 2e-3
DUSTYBOX_TP_GAS = 1e-3
DUSTYBOX_TP_DUST = 3e-3
DUSTYBOX_N3 = 64
DUSTYBOX_STEPS_WARM = 2
DUSTYBOX_STEPS_TIMED = 16
DUST_NHYDRO = 131072
DUST_STEPS_WARM = 2
DUST_STEPS_TIMED = 32
# the SPH gravity gate on E = kinetic + thermal + potential, the drag's
# heating in the thermal term
DUST_ENERGY_DRIFT_TOL = 1e-2
# Saitoh & Makino (2012) SPH (phases 44-49): the kernels' lattice sides
# per ndim (4,096 and 32,768 particles), tests/test_sm2012.py's 1D gates
# (the Sod tube 256 + 64 to t = 0.25, :45-64; the contact discontinuity,
# :67-97), and the vertical field of tests/test_extpot.py:18-42
SM_KERNEL_SIDES = {1: (4096, 32768), 2: (64, 181), 3: (16, 32)}
SM_SOD = (256, 64, 0.25)
SM_SOD_L1_GATE = 0.03
SM_SOD_ENERGY_TOL = 1e-4
SM_CONTACT_VMAX = 0.05
SM_CONTACT_RATIO = 0.8
EXTPOT_AVERT = -0.5
EXTPOT_TOL = 1e-10
EXTPOT_STEPS = 8
# RadWS and radiative feedback (phases 50-55): the kernels' sizes (K30
# also at the embedded cluster's 4,096 slots, K16's shape), the T gates
# of tests/test_radws.py (10% of temp_ambient for SPH, :96-104 and
# :106-130; 12% for MFV, :320-335), the block ticks and the cluster's
# gas particles
RADWS_N = 262144
RADWS_DENSE = (4096, 64)
RADWS_SLOTS = (16, 4096)
RADWS_T_TOL = 0.1
RADWS_MFV_T_TOL = 0.12
RADWS_BLOCK_WARM = 2
RADWS_BLOCK_TICKS = 32
RADFB_N = 262144
# the radiative-feedback cluster's timed steps: each takes about 1 s on
# the host, and 8 (32 until phases 105-108 came, 16 until phases
# 113-117) leave the script room under its time limit
RADFB_STEPS_TIMED = 8
RADWS_PARITY_N = 8
# the quintic, gaussian and tabulated kernels (phases 56-62): the
# variants of the grid path's K2, K3, K7-K9 beside the direct M4, the
# parity box and block runs, the tabulated quintic's timed steps, the
# sound wave's gate (tests/test_soundwave.py:46) and the quintic block
# run's ticks
FAMILY_VARIANTS = ("quintic", "gaussian", "m4_tab", "quintic_tab")
FAMILY_PARITY_N = 8
FAMILY_PARITY_STEPS = 3
FAMILY_BLOCK_TICKS = 3
TAB_QUINTIC_STEPS = 8
SOUNDWAVE_L1_GATE = 1e-4
QUINTIC_BLOCK_WARM = 4
QUINTIC_BLOCK_TICKS = 16
# the quintic block run's energy gate.  The JAX package's quintic wzeta
# is -(359/12) times the h-derivative of s wpot that M4's is (ROADMAP
# fault F24, kept for parity), so its grad-h gravity correction is wrong:
# on an H100 this run drifted 9.97e-3 over 32 ticks at 258,135
# particles in float32 (3.2e-3 over 16), block_main_path's M4 1.27e-4.
# The gate is twice the 32-tick reading.
QUINTIC_BLOCK_ENERGY_DRIFT_TOL = 2e-2
# MFV's options and its 1D and 2D grid path (phases 63-70): the reference
# gates of tests/test_mfv.py (AdSodMeshlessTest, L1(vx) < 7e-3 at 512 +
# 128 and t = 0.5; the limiter names at 128 + 32 to t = 0.1 with vx.max()
# > 0.3), tests/test_soundwave.py:50-53 (L1(rho) < 2e-3) and
# tests/test_ic_2d.py:78-109 (Gresho at 32^2 to t = 0.3, L1(v_phi) <
# 0.12); the 2D box of tests/test_mfv_grid.py:19-41 at x16 per axis
# (524,288 particles) with tests/test_ic_2d.py:67-75's KHI gates on the
# density (min rho < 1.3, max rho > 1.6)
MFV_SOD_L1_GATE = 7e-3
MFV_LIMITER_NAMES = ("scalar", "null", "zeroslope", "tvdscalar",
                     "springel2009", "tess2011", "balsara2004")
MFV_LIMITER_VX = 0.3
MFV_SOUNDWAVE_GATE = 2e-3
GRESHO_N = 32
GRESHO_L1_GATE = 0.12
MFV_KHI_N = 512
MFV_KHI_STEPS = (32, 16)
MFV_KHI_ENERGY_TOL = 2e-3
# block-timestep MFV (phases 71-75): the JAX package's block gates
# (tests/test_mfv_block.py): the tube to t = 0.1 with L1(v) < 2e-3 and
# L1(rho) < 1e-3 of the block run against the global one, the KHI's sum
# Q_E within 5e-2; the conservative bound at 2,048 sampled particles at or
# above the all-pairs oracle, median ratio below 10
MFV_BLOCK_KERNEL_TICKS = 3
MFV_BLOCK_TUBE_T = 0.1
MFV_BLOCK_TUBE_L1_V = 2e-3
MFV_BLOCK_TUBE_L1_RHO = 1e-3
MFV_BLOCK_WARM = 2
MFV_BLOCK_KHI_TICKS = (32, 16)
MFV_BLOCK_KHI_ENERGY_TOL = 5e-2
MFV_BLOCK_ORACLE_N = 2048
MFV_BLOCK_SPHERE_WARM = 4
MFV_BLOCK_SPHERE_TICKS = 32
MFV_BLOCK_SPHERE_ENERGY_TOL = 2e-3
# radiation (phases 76-80): the Spitzer HII region at full width, its
# steps (each with its radiation update), the parity runs' sizes (as
# tests/test_torch_radiation_sim.py's) and the gates of
# tests/test_spitzer.py:93, tests/test_treeray.py:195 and
# tests/test_mcrt.py:122
SPITZER_N = 262144
SPITZER_STEPS = 4
RAD_PARITY_N = 300
RAD_PARITY_MC_N = 700
RAD_PARITY_MC_ACROSS = 50.0
RAD_PARITY_STEPS = 3
RAD_KERNEL_N = 262144
SPITZER_FRONT_TOL = {"ionisation": 0.08, "treeray": 0.1}
SPITZER_MC_RADIUS_TOL = 0.15
# block timesteps below 3D (phases 81-86): K8 and K9 at ndim 1 and 2 on
# the block Sod tube and the KHI at x4 per axis (26,624 particles), the
# parity runs' ticks, tests/test_block.py's tube gates (:131-155 to t =
# 0.25, and :90-103's block against global run to t = 0.2), the KHI at
# full width and the 2D Sedov blast at 512^2 (their warm-up and timed
# ticks), and tests/test_dust.py:112-133's block dusty box to t = 1
DIMS_ACTIVE_KHI_SCALE = 4
BLOCK_DIMS_PARITY_TICKS = 8
BLOCK_TUBE_T = 0.25
BLOCK_TUBE_L1 = 0.02
BLOCK_TUBE_FRACTION = 0.8
BLOCK_GLOBAL_T = 0.2
BLOCK_GLOBAL_MEDIAN = 5e-3
BLOCK_GLOBAL_MAX = 0.08
BLOCK_KHI_WARM = 4
BLOCK_KHI_TICKS = 32
SEDOV_N = 512
SEDOV_NLEVELS = 5
SEDOV_WARM = 2
SEDOV_TICKS = 32
SEDOV_FRACTION = 0.8
DUSTYBOX_BLOCK_T = 1.0
# self-gravity below 3D (phases 87-92): K4-K7 at ndim 1 and 2 on the disc
# and the rod of check.disc_params at about 4,096 particles in each walk
# option, the 2D disc at full width (262,144 particles: warm-up and
# timed steps, and the block run's ticks), the 2D periodic box at 256^2
# with ewald = 0, the MFV disc at about 65,536, and the float64 parity
# runs: the 2D disc at about 2,000 under a global dt and Nlevels 4 and
# the 1D rod at 4,096.
TREE_DIMS_N = 4096
DISC_N = 262144
DISC_STEPS_WARM = 2
DISC_STEPS_TIMED = 32
DISC_BLOCK_TICKS_WARM = 4
DISC_BLOCK_TICKS_TIMED = 32
GBOX_SIDE = 256
GBOX_STEPS = 16
MFV_DISC_N = 65536
MFV_DISC_STEPS = 16
DIMS_GRAVITY_PARITY = (("disc_2d", 2, 2000, 1), ("disc_block_2d", 2, 2000, 4),
                       ("rod_1d", 1, 4096, 1))
DIMS_GRAVITY_PARITY_STEPS = 8
# gates of the 2D disc, set before its first run on the card.  The JAX
# package's tree (float64, the controller's plan, hydro forces off) reads
# rms|da|/rms|a| = 4.03e-4 against its all-pairs sum at setup of the
# 1,528-particle disc (tests/test_torch_tree_dims.py) and 7.31e-4 at
# 65,601 (the slow-marked test there); the port's plain versions agree
# with it to 1e-12 and read 5.37e-4 at 16,292, so the error grows with
# N.  The global gate is twice the JAX value at 65,601; the block gate
# stands to it as the 3D block gate (6e-4) stands to the JAX error on
# the 3D sphere (3.9e-4), 1.54 times.  The energy gates are the 3D
# paths': 1e-2 over the global window, 2e-3 over the block one.
DISC_JAX_ACCURACY = 7.31e-4
DISC_ACCURACY_TOL = 2.0 * DISC_JAX_ACCURACY
DISC_BLOCK_ACCURACY_TOL = 1.54 * DISC_JAX_ACCURACY
DISC_ENERGY_DRIFT_TOL = 1e-2
DISC_BLOCK_ENERGY_DRIFT_TOL = 2e-3
# sinks below 3D (phases 93-97): the kernels at NDIM 1 and 2 on
# check.sink_kernel_inputs; the 2D disc of gravity_disc_2d with sinks
# under a global dt and under Nlevels 4 with smooth accretion (rho_sink
# set from the bootstrap's rho, check.sink_disc_sim), at least
# SINK_DISC_MIN_SINKS formed in the timed window; the binaryacc IC at
# two lattices of 256 x 512; the parity runs (tag, case, steps)
SINK_DIMS_SIZES = ((4096, 16), (4096, 64))
SINK_DISC_STEPS = 32
SINK_DISC_BLOCK_WARM = 4
SINK_DISC_BLOCK_TICKS = 32
SINK_DISC_MIN_SINKS = 8
BINARYACC_SIDE = 256
BINARYACC_STEPS = 32
SINK_DIMS_PARITY_STEPS = 8
# radiation and radiative feedback below 3D, phases 98-104
RAD_DIMS_SIZES = {2: 262144, 1: 65536}
RAD_DIMS_SLOTS = 64
HII_2D_N = 262144
HII_2D_STEPS = 4
# the 2D fronts' bands: ionisation and treeray as the Spitzer sphere's
# (check.SPITZER_FRONT_TOL); the Monte-Carlo ionised radius within 20% of
# Rs: the JAX package's own 2D run on the CPU (16,053 particles, 45 x 45
# cells, cross-section 400, the same optical depth a cell as 1,600 at
# 262,144, 10 iterations) reads 0.3990, 14% beyond Rs, closing in from
# outside as the grid refines (22% at 3,969, 33% at 1,020)
HII_2D_FRONT_TOL = {"ionisation": 0.08, "treeray": 0.1}
HII_2D_MC_RADIUS_TOL = 0.2
RADFB_DISC_STEPS = 16
# radfb_disc_2d's thermodynamics: the disc starts near its radiative
# equilibrium, at the radws table's floor (T = 1: press1 0.32, u 1.5 at
# rho 0.318), under a disc profile of temp_au 1 (u ends at ~1.53 in 16
# steps); with radws_params' hot box's press1 (u ~ 314) and temp_au 250
# the expanding disc outran four grid replans within one step of a full
# run (NVIDIA H100 80GB HBM3, 700 W)
RADFB_DISC_PRESS = 0.32
RADFB_DISC_TEMP_AU = 1.0
RAD_DIMS_PARITY_STEPS = 3
CLI_SIDE = 64
CLI_TEND = 0.05
CLI_STOP_STEPS = 12
# the smoothing-kernel family in MFV (phases 105-108): every variant but
# the direct M4 (kernels.smoothing.VARIANTS), K12 in its modes of
# check.MFV_FAMILY_FLUX_MODES and its block mode; the variants of the
# full-width block sphere and 2D KHI
MFV_FAMILY_VARIANTS = FAMILY_VARIANTS + ("gaussian_tab",)
MFV_FAMILY_SPHERE_VARIANT = "quintic_tab"
MFV_FAMILY_KHI_VARIANT = "gaussian"
# the quintic sphere's energy gate: F24's wrong quintic wzeta (copied
# for parity) spoils the grad-h gravity correction, as it does in SPH's
# quintic_block.  On an H100 the block MFV sphere (258,135 particles,
# float32, 32 ticks) drifted 8.20e-3 with the tabulated quintic (M4's
# 1.92e-5); the direct quintic drifts as much, the tabulated M4 as
# little as M4: the quintic, not the table, takes the sphere past
# MFV_BLOCK_SPHERE_ENERGY_TOL.  The gate is QUINTIC_BLOCK_ENERGY_DRIFT_TOL.
MFV_FAMILY_SPHERE_ENERGY_TOL = QUINTIC_BLOCK_ENERGY_DRIFT_TOL
# 109-112. the kernel family in cd2010, dust and SM2012 (K21, K23-K26):
# every variant against the plain versions, the parity runs' steps (and
# dense block ticks), the variants of the full-width KHI runs (16 timed
# steps each, half of khi_sm2012's and khi_cd2010's 32) and of the
# dusty Evrard run (8 timed steps)
GRID_FAMILY_VARIANTS = MFV_FAMILY_VARIANTS
GRID_FAMILY_PARITY_STEPS = 3
GRID_FAMILY_DUSTYBOX_VARIANTS = ("gaussian", "quintic_tab")
GRID_FAMILY_DUSTYBOX_STEPS = 5
FAMILY_KHI_SM2012_VARIANT = "quintic"
FAMILY_KHI_CD2010_VARIANT = "gaussian"
FAMILY_KHI_STEPS = 16
DUSTY_EVRARD_TAB_VARIANT = "m4_tab"
DUSTY_EVRARD_TAB_STEPS = 8
# 113-117. the kernel family in sinks, stars and softened N-body (K14,
# K16, K20): every variant with softened gravity against the plain
# versions (check.SINK_FAMILY_VARIANTS at check.SINK_FAMILY_SIZES), the
# timed rows' sizes (K16 and K20 at the embedded cluster, K14 at
# plummer_cluster's stars), the parity runs (as sink_parity's and
# nbody_parity's, and the 2D disc of 384 with Nlevels 3 and smooth
# accretion, its dense ticks) and the variants of the full-width runs
SINK_FAMILY_TIMED_STARS = NBODY_N
SINK_FAMILY_PARITY_DISC = 384
SINK_FAMILY_PARITY_TICKS = 8
BB_TAB_VARIANT = "m4_tab"
SINK_DISC_QUINTIC_VARIANT = "quintic"
PLUMMER_TAB_VARIANT = "m4_tab"
# the quintic sink disc's energy gate (sink_block_disc_2d has none: its
# energy is recorded beside it).  F24's wrong quintic wzeta (copied for
# parity) spoils the grad-h gravity correction, as in quintic_block: the
# gate is QUINTIC_BLOCK_ENERGY_DRIFT_TOL.
SINK_DISC_QUINTIC_ENERGY_TOL = QUINTIC_BLOCK_ENERGY_DRIFT_TOL
# 118-120. the distributed controller: Nmpi = 4 shards on the one card;
# the kernel comparisons and the parity runs at 16^3 (float64), the
# parity's 3 steps with the decomposition rebuilt every 2; the main
# path at 64^3 in float32, 32 timed steps after 2 warm-up steps with the
# rebuild cadence at step 24 (one host replan in the window); its gpot
# gates are the JAX package's distributed ones against the direct sum
# (tests/test_dist.py:126-131) and its energy gate the single-device
# gravity path's
DIST_S = 4
DIST_KERNEL_N = 16
DIST_PARITY_N = 16
DIST_PARITY_STEPS = 3
DIST_PARITY_NTB = 2
DIST_STEPS_TIMED = 32
DIST_NTB = 24
DIST_GPOT_MEDIAN_TOL = 2e-3
DIST_GPOT_P99_TOL = 3e-2
DIST_ENERGY_DRIFT_TOL = GRAVITY_ENERGY_DRIFT_TOL

SOURCES = {
    "grid27_bin": ("gandalf_tpu_torch/csrc/grid27_bin.cu",
                   "gandalf_tpu/ops/sph_grid27.py:193"),
    "grid27_density": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                       "gandalf_tpu/ops/sph_grid27.py:359"),
    "grid27_forces": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                      "gandalf_tpu/ops/sph_grid27.py:528"),
    "tree_gather": ("gandalf_tpu_torch/csrc/tree_gather.cu",
                    "gandalf_tpu/ops/tree.py:1357"),
    "tree_build": ("gandalf_tpu_torch/csrc/tree_build.cu",
                   "gandalf_tpu/ops/tree.py:153"),
    "tree_walk": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                  "gandalf_tpu/ops/tree.py:287"),
    "tree_near": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                  "gandalf_tpu/ops/tree.py:635"),
    "active_density": ("gandalf_tpu_torch/csrc/active_density.cu",
                       "gandalf_tpu/ops/active_grid.py:107"),
    "active_forces": ("gandalf_tpu_torch/csrc/active_forces.cu",
                      "gandalf_tpu/ops/active_grid.py:140"),
    "tree_walk_list": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                       "gandalf_tpu/ops/tree.py:1429"),
    "tree_near_list": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                       "gandalf_tpu/ops/tree.py:1429"),
    "mfv_density": ("gandalf_tpu_torch/csrc/mfv_density.cu",
                    "gandalf_tpu/ops/mfv_grid27.py:70"),
    "mfv_gradients": ("gandalf_tpu_torch/csrc/mfv_gradients.cu",
                      "gandalf_tpu/ops/mfv_grid27.py:198"),
    "mfv_fluxes": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                   "gandalf_tpu/ops/mfv_grid27.py:342"),
    "tree_near_mfv": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                      "gandalf_tpu/ops/tree.py:770"),
    "mfv_fluxes_rk2": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                       "gandalf_tpu/ops/mfv.py:793"),
    "mfv_fluxes_exact_cell": ("gandalf_tpu_torch/csrc/riemann_exact.cuh",
                              "gandalf_tpu/ops/mfv.py:509"),
    "mfv_limiter_springel2009": ("gandalf_tpu_torch/csrc/mfv_limiter.cu",
                                 "gandalf_tpu/ops/mfv_grid27.py:281"),
    "mfv_density_2d": ("gandalf_tpu_torch/csrc/mfv_density.cu",
                       "gandalf_tpu/ops/mfv_grid27.py:70"),
    "mfv_gradients_2d": ("gandalf_tpu_torch/csrc/mfv_gradients.cu",
                         "gandalf_tpu/ops/mfv_grid27.py:198"),
    "mfv_fluxes_2d": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                      "gandalf_tpu/ops/mfv_grid27.py:342"),
    "mfv_fluxes_exact_cell_2d": ("gandalf_tpu_torch/csrc/riemann_exact.cuh",
                                 "gandalf_tpu/ops/mfv.py:509"),
    "mfv_limiter_tvdscalar_2d": ("gandalf_tpu_torch/csrc/mfv_limiter.cu",
                                 "gandalf_tpu/ops/mfv_grid27.py:281"),
    "mfv_density_1d": ("gandalf_tpu_torch/csrc/mfv_density.cu",
                       "gandalf_tpu/ops/mfv_grid27.py:70"),
    "mfv_gradients_1d": ("gandalf_tpu_torch/csrc/mfv_gradients.cu",
                         "gandalf_tpu/ops/mfv_grid27.py:198"),
    "mfv_fluxes_1d": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                      "gandalf_tpu/ops/mfv_grid27.py:342"),
    "mfv_fluxes_rk2_1d": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                          "gandalf_tpu/ops/mfv.py:793"),
    "mfv_fluxes_exact_cell_1d": ("gandalf_tpu_torch/csrc/riemann_exact.cuh",
                                 "gandalf_tpu/ops/mfv.py:509"),
    "mfv_limiter_tvdscalar_1d": ("gandalf_tpu_torch/csrc/mfv_limiter.cu",
                                 "gandalf_tpu/ops/mfv_grid27.py:281"),
    "mfv_fluxes_cell_1d": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                           "gandalf_tpu/ops/mfv.py:740"),
    "mfv_fluxes_zeroslope_1d": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                                "gandalf_tpu/ops/mfv.py:740"),
    "mfv_limiter_springel2009_1d": ("gandalf_tpu_torch/csrc/mfv_limiter.cu",
                                    "gandalf_tpu/ops/mfv_grid27.py:281"),
    "direct_nbody": ("gandalf_tpu_torch/csrc/nbody_direct.cu",
                     "gandalf_tpu/ops/gravity.py:30"),
    "direct_softened": ("gandalf_tpu_torch/csrc/nbody_direct.cu",
                        "gandalf_tpu/ops/gravity.py:86"),
    "direct_snap": ("gandalf_tpu_torch/csrc/nbody_direct.cu",
                    "gandalf_tpu/ops/gravity.py:60"),
    "tree_walk_ewald": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                        "gandalf_tpu/ops/tree.py:556"),
    "tree_near_ewald": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                        "gandalf_tpu/ops/tree.py:687"),
    "tree_walk_gadget2": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                          "gandalf_tpu/ops/tree.py:457"),
    "tree_walk_eigenmac": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                           "gandalf_tpu/ops/tree.py:463"),
    "tree_walk_fast": ("gandalf_tpu_torch/csrc/tree_walk.cuh",
                       "gandalf_tpu/ops/tree.py:481"),
    "tree_near_fast": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                       "gandalf_tpu/ops/tree.py:848"),
    "star_gas_forces": ("gandalf_tpu_torch/csrc/star_gas.cu",
                        "gandalf_tpu/ops/sph_gravity.py:30"),
    "sink_candidate": ("gandalf_tpu_torch/csrc/sinks.cu",
                       "gandalf_tpu/ops/sinks.py:94"),
    "accretion_sums": ("gandalf_tpu_torch/csrc/sinks.cu",
                       "gandalf_tpu/ops/sinks.py:134"),
    "grid27_bin_2d": ("gandalf_tpu_torch/csrc/grid27_bin.cu",
                      "gandalf_tpu/ops/sph_grid27.py:193"),
    "grid27_density_2d": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                          "gandalf_tpu/ops/sph_grid27.py:359"),
    "grid27_forces_2d": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                         "gandalf_tpu/ops/sph_grid27.py:528"),
    "grid27_bin_1d": ("gandalf_tpu_torch/csrc/grid27_bin.cu",
                      "gandalf_tpu/ops/sph_grid27.py:193"),
    "grid27_density_1d": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                          "gandalf_tpu/ops/sph_grid27.py:359"),
    "grid27_forces_1d": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                         "gandalf_tpu/ops/sph_grid27.py:528"),
    "grid27_mirror": ("gandalf_tpu_torch/csrc/grid27_mirror.cu",
                      "gandalf_tpu/ops/sph_grid27.py:234"),
    "smooth_accretion": ("gandalf_tpu_torch/csrc/sinks.cu",
                         "gandalf_tpu/ops/sinks.py:182"),
    "cullen_dehnen": ("gandalf_tpu_torch/csrc/cullen_dehnen.cu",
                      "gandalf_tpu/ops/forces.py:267"),
    "cullen_dehnen_2d": ("gandalf_tpu_torch/csrc/cullen_dehnen.cu",
                         "gandalf_tpu/ops/forces.py:267"),
    "cullen_dehnen_1d": ("gandalf_tpu_torch/csrc/cullen_dehnen.cu",
                         "gandalf_tpu/ops/forces.py:267"),
    "levelneib": ("gandalf_tpu_torch/csrc/grid27_levelneib.cu",
                  "gandalf_tpu/sim/simulation.py:1682"),
    "dust_drag_sums": ("gandalf_tpu_torch/csrc/dust_drag.cuh",
                       "gandalf_tpu/ops/dust.py:177"),
    "dust_drag_deposit": ("gandalf_tpu_torch/csrc/dust_drag.cuh",
                          "gandalf_tpu/ops/dust.py:255"),
    "sm2012_density": ("gandalf_tpu_torch/csrc/sm2012.cu",
                       "gandalf_tpu/ops/sm2012.py:198"),
    "sm2012_forces": ("gandalf_tpu_torch/csrc/sm2012.cu",
                      "gandalf_tpu/ops/sm2012.py:228"),
    "sm2012_density_2d": ("gandalf_tpu_torch/csrc/sm2012.cu",
                          "gandalf_tpu/ops/sm2012.py:198"),
    "sm2012_forces_2d": ("gandalf_tpu_torch/csrc/sm2012.cu",
                         "gandalf_tpu/ops/sm2012.py:228"),
    "sm2012_density_1d": ("gandalf_tpu_torch/csrc/sm2012.cu",
                          "gandalf_tpu/ops/sm2012.py:198"),
    "sm2012_forces_1d": ("gandalf_tpu_torch/csrc/sm2012.cu",
                         "gandalf_tpu/ops/sm2012.py:228"),
    "radws_eos": ("gandalf_tpu_torch/csrc/radws.cu",
                  "gandalf_tpu/ops/radws.py:133"),
    "radws_equilibrium": ("gandalf_tpu_torch/csrc/radws.cu",
                          "gandalf_tpu/ops/radws.py:156"),
    "radws_implicit_heating": ("gandalf_tpu_torch/csrc/radws.cu",
                               "gandalf_tpu/ops/radws.py:229"),
    "ambient_temperature": ("gandalf_tpu_torch/csrc/radiative_fb.cu",
                            "gandalf_tpu/ops/radiative_fb.py:92"),
    "cell_field": ("gandalf_tpu_torch/csrc/radiation.cu",
                   "gandalf_tpu/ops/treeray.py:104"),
    "ray_march": ("gandalf_tpu_torch/csrc/radiation.cu",
                  "gandalf_tpu/ops/treeray.py:123"),
    "packet_march": ("gandalf_tpu_torch/csrc/radiation.cu",
                     "gandalf_tpu/ops/mcrt.py:83"),
    "stromgren_prefix": ("gandalf_tpu_torch/csrc/radiation.cu",
                         "gandalf_tpu/ops/ionisation.py:67"),
}
# K30 and K34-K37 below 3D: 2D from the hii_region_2d phases and
# radfb_disc_2d, 1D from radiation_dims_parity's rods on the card
for _d in ("_2d", "_1d"):
    for _k in ("ambient_temperature", "cell_field", "ray_march",
               "packet_march", "stromgren_prefix"):
        SOURCES[f"{_k}{_d}"] = SOURCES[_k]
# block-timestep MFV: K12's block mode (3D from mfv_block_sphere, 2D from
# mfv_block_khi, 1D from mfv_block_tube), K22 below 3D (2D from the KHI,
# 1D from the tube), K32 and K33 (3D from the sphere, 2D from the KHI's
# conservative run)
for _d in ("", "_2d", "_1d"):
    SOURCES[f"mfv_fluxes_block{_d}"] = (
        "gandalf_tpu_torch/csrc/mfv_fluxes.cuh", "gandalf_tpu/ops/mfv.py:815")
for _d in ("_2d", "_1d"):
    SOURCES[f"levelneib{_d}"] = ("gandalf_tpu_torch/csrc/grid27_levelneib.cu",
                                 "gandalf_tpu/sim/mfv_sim.py:345")
for _d in ("", "_2d"):
    SOURCES[f"mfv_vsig_near{_d}"] = ("gandalf_tpu_torch/csrc/mfv_vsig.cu",
                                     "gandalf_tpu/ops/mfv_grid27.py:485")
    SOURCES[f"mfv_vsig_far{_d}"] = ("gandalf_tpu_torch/csrc/mfv_vsig.cu",
                                    "gandalf_tpu/ops/mfv_grid27.py:566")
# K8 and K9 below 3D: 2D from block_khi_2d, 1D from block_sod_tube
for _d in ("_2d", "_1d"):
    SOURCES[f"active_density{_d}"] = SOURCES["active_density"]
    SOURCES[f"active_forces{_d}"] = SOURCES["active_forces"]
# K4-K7 below 3D: 2D from gravity_disc_2d, the list K6 and K7 from
# gravity_block_disc_2d, K7's MFV mode from mfv_gravity_disc_2d, 1D from
# gravity_dims_parity's run of the rod on the card (float64)
for _d in ("_2d", "_1d"):
    for _k in ("tree_gather", "tree_build", "tree_walk", "tree_near"):
        SOURCES[f"{_k}{_d}"] = SOURCES[_k]
for _k in ("tree_walk_list", "tree_near_list", "tree_near_mfv"):
    SOURCES[f"{_k}_2d"] = SOURCES[_k]
# K14 and the sink kernels below 3D: 2D from sink_disc_2d (K20 from
# sink_block_disc_2d), 1D from sink_dims_parity's rods on the card
# (float64; K18 from the plain-accretion rod)
for _d in ("_2d", "_1d"):
    for _k in ("direct_softened", "star_gas_forces", "sink_candidate",
               "accretion_sums", "smooth_accretion"):
        SOURCES[f"{_k}{_d}"] = SOURCES[_k]
# the quintic, gaussian and tabulated variants on their main paths: the
# JAX functions' kernel evaluations they replace
_FAMILY_SOURCES = {
    "grid27_density": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                       "gandalf_tpu/ops/sph_grid27.py:439"),
    "grid27_forces": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                      "gandalf_tpu/ops/sph_grid27.py:680"),
    "tree_near": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                  "gandalf_tpu/ops/tree.py:768"),
    "active_density": ("gandalf_tpu_torch/csrc/active_density.cu",
                       "gandalf_tpu/ops/active_grid.py:118"),
    "active_forces": ("gandalf_tpu_torch/csrc/active_forces.cu",
                      "gandalf_tpu/ops/active_grid.py:179"),
    "tree_near_list": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                       "gandalf_tpu/ops/tree.py:768"),
}
for _base, _variants in (
        ("grid27_density", ("quintic", "m4_tab", "quintic_tab", "gaussian",
                            "gaussian_1d")),
        ("grid27_forces", ("quintic", "m4_tab", "quintic_tab", "gaussian",
                           "gaussian_1d")),
        ("tree_near", ("quintic", "m4_tab", "quintic_tab")),
        ("active_density", ("quintic",)), ("active_forces", ("quintic",)),
        ("tree_near_list", ("quintic",))):
    for _v in _variants:
        SOURCES[f"{_base}_{_v}"] = _FAMILY_SOURCES[_base]
# the MFV kernels with the smoothing-kernel family on their main paths:
# the quintic from mfv_quintic_box, the tabulated quintic from
# mfv_family_block's sphere (K12's block mode), the gaussian from its
# 2D KHI; the JAX functions' kernel evaluations they replace
_MFV_FAMILY_SOURCES = {
    "mfv_density": ("gandalf_tpu_torch/csrc/mfv_density.cu",
                    "gandalf_tpu/ops/mfv_grid27.py:124"),
    "mfv_gradients": ("gandalf_tpu_torch/csrc/mfv_gradients.cu",
                      "gandalf_tpu/ops/mfv.py:207"),
    "mfv_fluxes": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                   "gandalf_tpu/ops/mfv.py:709"),
    "mfv_fluxes_block": ("gandalf_tpu_torch/csrc/mfv_fluxes.cuh",
                         "gandalf_tpu/ops/mfv.py:709"),
    "tree_near_mfv": ("gandalf_tpu_torch/csrc/tree_near.cuh",
                      "gandalf_tpu/ops/tree.py:768"),
}
for _base, _keys in (
        ("mfv_density", ("quintic", "quintic_tab", "gaussian_2d")),
        ("mfv_gradients", ("quintic", "quintic_tab", "gaussian_2d")),
        ("mfv_fluxes", ("quintic", "gaussian_2d")),
        ("mfv_fluxes_block", ("quintic_tab",)),
        ("tree_near_mfv", ("quintic", "quintic_tab"))):
    for _v in _keys:
        SOURCES[f"{_base}_{_v}"] = _MFV_FAMILY_SOURCES[_base]
# K21, K23-K26 with the family on their main paths: K25 and K26 with the
# quintic from family_khi_2d's SM2012 run, K21 with the gaussian from its
# cd2010 run, K23 and K24 with the tabulated M4 from dusty_evrard_tab;
# the JAX functions' kernel evaluations they replace
SOURCES.update({
    f"sm2012_density_{FAMILY_KHI_SM2012_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/sm2012.cu", "gandalf_tpu/ops/sm2012.py:208"),
    f"sm2012_forces_{FAMILY_KHI_SM2012_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/sm2012.cu", "gandalf_tpu/ops/sm2012.py:143"),
    f"cullen_dehnen_{FAMILY_KHI_CD2010_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/cullen_dehnen.cu",
        "gandalf_tpu/ops/forces.py:322"),
    f"dust_drag_sums_{DUSTY_EVRARD_TAB_VARIANT}": (
        "gandalf_tpu_torch/csrc/dust_drag.cuh",
        "gandalf_tpu/ops/dust.py:209"),
    f"dust_drag_deposit_{DUSTY_EVRARD_TAB_VARIANT}": (
        "gandalf_tpu_torch/csrc/dust_drag.cuh",
        "gandalf_tpu/ops/dust.py:255"),
})
# K14, K16 and K20 with the family on their main paths: K16 with the
# tabulated M4 from bb_sink_collapse_tab, K14 with it from
# plummer_cluster_tab, K14, K16 and K20 (2D) with the quintic from
# sink_block_disc_2d_quintic; the JAX functions' kernel evaluations they
# replace
SOURCES.update({
    f"star_gas_forces_{BB_TAB_VARIANT}": (
        "gandalf_tpu_torch/csrc/star_gas.cu",
        "gandalf_tpu/ops/sph_gravity.py:53"),
    f"direct_softened_{PLUMMER_TAB_VARIANT}": (
        "gandalf_tpu_torch/csrc/nbody_direct.cu",
        "gandalf_tpu/ops/gravity.py:103"),
    f"direct_softened_{SINK_DISC_QUINTIC_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/nbody_direct.cu",
        "gandalf_tpu/ops/gravity.py:103"),
    f"star_gas_forces_{SINK_DISC_QUINTIC_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/star_gas.cu",
        "gandalf_tpu/ops/sph_gravity.py:53"),
    f"smooth_accretion_{SINK_DISC_QUINTIC_VARIANT}_2d": (
        "gandalf_tpu_torch/csrc/sinks.cu", "gandalf_tpu/ops/sinks.py:216"),
})
# the distributed controller's kernels: K1 with zrow_max, K2 and K3 on a
# ghosted slab (the single-device kernels with a row window), and K38
SOURCES.update({
    "grid27_bin_slab": ("gandalf_tpu_torch/csrc/grid27_bin.cu",
                        "gandalf_tpu/ops/sph_grid27.py:193"),
    "grid27_density_slab": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                            "gandalf_tpu/ops/sph_grid27.py:359"),
    "grid27_forces_slab": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                           "gandalf_tpu/ops/sph_grid27.py:528"),
    "let_far_walk": ("gandalf_tpu_torch/csrc/let_far.cu",
                     "gandalf_tpu/parallel/let.py:330"),
})
HYDRO = ("grid27_bin", "grid27_density", "grid27_forces")
GRAVITY = HYDRO + ("tree_gather", "tree_build", "tree_walk", "tree_near")
# the kernels of a block tick with self-gravity
BLOCK = ("grid27_bin", "active_density", "active_forces", "tree_gather",
         "tree_build", "tree_walk_list", "tree_near_list")
# the kernels of an MFV step with self-gravity (K1 twice a step)
MFV = ("grid27_bin", "tree_gather", "tree_build", "tree_walk",
       "tree_near_mfv", "mfv_density", "mfv_gradients", "mfv_fluxes")
NBODY = ("direct_nbody", "direct_softened", "direct_snap")
# the kernels of a step of the Ewald path
EWALD = HYDRO + ("tree_gather", "tree_build", "tree_walk_ewald",
                 "tree_near_ewald")
# the kernels of a step of the sink path
SINK = ("star_gas_forces", "sink_candidate", "accretion_sums",
        "direct_softened")
SINK_2D = tuple(f"{k}_2d" for k in SINK)
BB = GRAVITY + SINK
# the kernels of a dense block tick of bb_block_collapse
BB_BLOCK = GRAVITY + ("star_gas_forces", "sink_candidate",
                      "direct_softened", "smooth_accretion", "levelneib")
# the kernels of a step of dusty_evrard (K1 and K2 twice a step, and once
# more K1 for the drag's binning)
DUST = GRAVITY + ("dust_drag_sums", "dust_drag_deposit")
# the SM2012 kernels of a step (K25 and K26, after K1)
SM2012 = ("sm2012_density", "sm2012_forces")
# the kernels of a step of the distributed gravity path: K1-K3 on the
# shards' slabs, K4-K7 over the ring (K6 and K7 over the local groups'
# list) and K38
DIST = ("grid27_bin_slab", "grid27_density_slab", "grid27_forces_slab",
        "tree_gather", "tree_build", "tree_walk_list", "tree_near_list",
        "let_far_walk")
# the kernels of these paths that take the smoothing-kernel family and
# count under its variant's name (_ext.family_count)
FAMILY_KERNELS = ("grid27_density", "grid27_forces", "tree_near",
                  "cullen_dehnen", "dust_drag_sums", "dust_drag_deposit",
                  "sm2012_density", "sm2012_forces")
SINK_FAMILY = ("direct_softened", "star_gas_forces", "smooth_accretion")
# the radws kernels of an SPH step or tick (the table EOS, the
# equilibrium finder)
RADWS_SPH = ("radws_eos", "radws_equilibrium")
# the kernels of each radiation scheme's update (K1 bins for the
# per-cell field)
RADIATION = {"ionisation": ("stromgren_prefix",),
             "treeray": ("grid27_bin", "cell_field", "ray_march"),
             "monoionisation": ("grid27_bin", "cell_field", "packet_march")}
# rates of earlier phases that later ones print beside their own
RATES = {}
# the script's start, for each phase line's elapsed_s
T0 = time.perf_counter()


def phase(tag: str, **fields) -> None:
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": tag, "elapsed_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def energy(s, gravity: bool = False) -> float:
    e = s.m * (0.5 * torch.sum(s.v * s.v, dim=-1) + s.u)
    if gravity:
        e = e - 0.5 * s.m * s.gpot
    return float(torch.sum(e.double()))


def make_block_sim(n_target, device, dtype):
    from gandalf_tpu_torch.check import sphere_block_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    return GradhSphSimulation(sphere_block_params(n_target), device=device,
                              dtype=dtype)


# the cold sphere's IC per particle count, generated once on the host
# (its 262,144-particle lattice takes ~27 s) and shared by the block
# paths of every kernel, with the seconds it took
_BLOCK_IC = {}


def block_ic(params):
    """A copy of the cold sphere's IC for `params` (sphere_block_params
    or check.disc_params at its Nhydro and ndim; the IC does not depend
    on the smoothing kernel)."""
    from gandalf_tpu_torch.sim.ic import generate_ic

    n = params.intparams["Nhydro"]
    key = n if params.intparams["ndim"] == 3 \
        else (n, params.intparams["ndim"])
    if key not in _BLOCK_IC:
        t0 = time.perf_counter()
        _BLOCK_IC[key] = (generate_ic(params, None),
                          time.perf_counter() - t0)
    return {k: v.copy() for k, v in _BLOCK_IC[key][0].items()}


def full_gravity_energy(sim) -> float:
    """E with gpot from one full tree pass over every particle (outside
    any timed window; its launches are not the path's)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import gravity_inputs
    from gandalf_tpu_torch.ops.tree import tree_gravity_grouped

    saved = dict(_ext.LAUNCHES)
    s = sim.state
    r, m, h, kern, zh, pext = gravity_inputs(sim, s)
    _, gpot, _ = tree_gravity_grouped(sim.treespec, s.bucket_map, r, m, h,
                                      kern, zh, pext)
    _ext.LAUNCHES.update(saved)
    return energy(s.replace(gpot=gpot), gravity=True)


def make_sim(n_side, device, dtype, self_gravity=0, ntreebuildstep=None):
    from gandalf_tpu_torch.check import jittered_box_ic, slice_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    params = slice_params(n_side, self_gravity=self_gravity)
    if ntreebuildstep is not None:
        params.set("ntreebuildstep", ntreebuildstep)
    sim = GradhSphSimulation(params, device=device, dtype=dtype)
    return sim, jittered_box_ic(params, n_side)


def parity_errors(sims, fields):
    """Largest error of each field, relative to its largest value, of the
    first simulation against the second."""
    errs = {}
    states = [s.gathered_state() for s in sims]
    for f in fields:
        x = getattr(states[0], f).cpu()
        ref = getattr(states[1], f)
        err, scale = torch.abs(x - ref).max(), torch.abs(ref).max()
        # a field that is 0 everywhere is held absolutely
        errs[f] = float(err / scale if scale > 0 else err)
    errs["t"] = abs(sims[0].t - sims[1].t) / sims[1].t
    return errs


def run_timed(sim, steps: int) -> float:
    """Seconds of `steps` steps through main_loop_steps, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        done += sim.main_loop_steps(steps - done)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def require_ok(tag, report):
    bad = [k for k, r in report.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"{tag}: kernel disagrees with its plain "
                           f"version: {bad}")


def block_parity(dev) -> None:
    """12 ticks of the 912-particle block sphere in float64, kernels on
    the card against the plain path on the CPU: the same active and
    Saitoh-Makino sets (rows of each pass) and levels on every tick, and
    fields within PARITY_TOL."""
    sims = []
    for device in (dev, torch.device("cpu")):
        sim = make_block_sim(BLOCK_PARITY_N, device, torch.float64)
        sim.SetupSimulation()
        sims.append(sim)
    same_sets = True
    for _ in range(BLOCK_PARITY_TICKS):
        for sim in sims:
            sim.main_loop_step()
        same_sets &= sims[0].last_tick_rows == sims[1].last_tick_rows
        same_sets &= bool(torch.equal(sims[0].state.level.cpu(),
                                      sims[1].state.level))
    torch.cuda.synchronize()
    errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot"))
    counts = [(s._n_tree_plans, s._n_grid_overflows, s.active_rows)
              for s in sims]
    levels = torch.bincount(sims[1].state.level).tolist()
    phase("block_parity", N=sims[1].state.N, ticks=BLOCK_PARITY_TICKS,
          rel_err=errs, same_active_sets_and_levels=same_sets,
          plans_replans_rows=counts, levels=levels)
    if max(errs.values()) > PARITY_TOL or counts[0] != counts[1] \
            or not same_sets:
        raise RuntimeError(f"block_parity: kernel path disagrees with the "
                           f"plain path: {errs} {counts} {same_sets}")


def block_main_path(dev, card):
    """The block slice at full size: setup, warm-up ticks, the timed
    ticks (tick by tick, as main_loop_steps runs them), then the checks
    and the kernels against their plain versions at the path's shapes.
    Returns the path's launch counts and the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_active_kernels,
                                         compare_kernels,
                                         compare_tree_kernels,
                                         gravity_accuracy)

    sim = make_block_sim(BLOCK_N, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(block_ic(sim.params))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    N = sim.state.N
    for _ in range(BLOCK_TICKS_WARM):
        sim.main_loop_step()
    e0 = full_gravity_energy(sim)
    t_sim0, rows0 = sim.t, sim.active_rows
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    replan0 = sim.timing.totals.get("GRID_REPLAN", 0.0)
    first_rows = []
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(BLOCK_TICKS_TIMED):
        sim.main_loop_step()
        first_rows.append(sim.last_tick_rows[0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _ext.LAUNCHES[k] for k in BLOCK}
    rows = sim.active_rows - rows0
    replans = sim._n_grid_overflows - replans0
    rebuild_s = sim.timing.totals.get("TREE_REBUILD", 0.0) - rebuild0
    replan_s = sim.timing.totals.get("GRID_REPLAN", 0.0) - replan0
    s = sim.state
    drift = abs(full_gravity_energy(sim) - e0) / abs(e0)
    active = torch.nonzero(s.nlast == sim._blocksched.n).flatten().to(
        torch.int32)
    acc = gravity_accuracy(sim, n_sample=2048, among=active)
    mono = gravity_accuracy(sim, n_sample=2048, among=active,
                            spec=dataclasses.replace(sim.treespec,
                                                     quadrupole=False))
    levels = torch.bincount(s.level.cpu()).tolist()
    mean_active = sum(first_rows) / (N * BLOCK_TICKS_TIMED)
    ticks = sim.Nsteps
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "two_levels": sum(1 for n in levels if n) >= 2,
        "compacts": mean_active < 1.0,
        "launches": all(launches[k] >= BLOCK_TICKS_TIMED for k in
                        ("active_density", "active_forces")),
        "accuracy": acc["rms_rel_err"] <= BLOCK_ACCURACY_TOL,
        "gate_rejects_monopole": mono["rms_rel_err"] > BLOCK_ACCURACY_TOL,
        "energy_drift": drift <= BLOCK_ENERGY_DRIFT_TOL,
    }
    rep = compare_kernels(sim, s, repeats=5)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    rep.update(compare_active_kernels(sim, s, active, repeats=5))
    spec = sim.treespec
    phase("block_main_path", N=N, ticks=ticks,
          timed_ticks=BLOCK_TICKS_TIMED, setup_s=t_setup,
          ic_s=_BLOCK_IC[BLOCK_N][1], timed_s=elapsed,
          ticks_per_s=BLOCK_TICKS_TIMED / elapsed,
          sim_time_per_wall_s=(sim.t - t_sim0) / elapsed,
          active_rows_per_s=rows / elapsed,
          N_ticks_per_s=N * BLOCK_TICKS_TIMED / elapsed,
          mean_active_fraction=mean_active, active_rows=rows,
          first_pass_rows=first_rows, levels=levels,
          level_max=int(sim._blocksched.level_max),
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=rebuild_s, replans_in_window=replans,
          replan_host_s=replan_s,
          G_pad=spec.n_leaves, near_cap=spec.near_cap,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, energy_drift=drift, accuracy=acc,
          monopole_accuracy=mono, accuracy_gate=BLOCK_ACCURACY_TOL,
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"block main path checks failed: {failed}")
    names = ("active_density", "active_forces", "tree_walk_list",
             "tree_near_list")
    return ({k: launches[k] for k in names}, {k: rep[k] for k in names})


def make_mfv_sim(n_side, device, dtype, ntreebuildstep=None):
    from gandalf_tpu_torch.check import jittered_box_ic, mfv_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    params = mfv_params(n_side, self_gravity=1)
    if ntreebuildstep is not None:
        params.set("ntreebuildstep", ntreebuildstep)
    sim = SimulationBase.factory(params, device, dtype)
    return sim, jittered_box_ic(params, n_side)


def mfv_energy(s) -> float:
    """Total energy of an MFV state: sum Q_E - sum m gpot / 2."""
    return float(torch.sum(s.Qcons0[:, 4].double())
                 - 0.5 * torch.sum((s.m * s.gpot).double()))


def mfv_kernels(dev) -> None:
    """K10-K12 and K7's MFV mode against their plain versions on the
    card, after setup and 2 steps of mfv_box."""
    from gandalf_tpu_torch.check import compare_mfv_kernels

    for n_side in (16, 32):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_mfv_sim(n_side, dev, dtype)
            sim.SetupSimulation(ic)
            sim.main_loop_steps(2)
            rep = compare_mfv_kernels(sim, sim.state)
            phase("mfv_kernels", n_side=n_side, dtype=str(dtype),
                  k_cell=sim.gridspec.k_cell, G=sim.treespec.n_leaves,
                  report=rep)
            require_ok("mfv_kernels", rep)


def mfv_parity(dev) -> None:
    """5 float64 steps of mfv_box at 16^3, kernels on the card against
    the plain path on the CPU, with a tree rebuild every 2 steps."""
    sims = []
    for device in (dev, torch.device("cpu")):
        sim, ic = make_mfv_sim(16, device, torch.float64,
                               ntreebuildstep=GRAVITY_NTB_PARITY)
        sim.SetupSimulation(ic)
        for _ in range(PARITY_STEPS):
            sim.main_loop_step()
        sims.append(sim)
    errs = parity_errors(sims, ("r", "v", "u", "m", "h", "rho", "Qcons0",
                                "a", "gpot"))
    counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
    phase("mfv_parity", n_side=16, steps=PARITY_STEPS, rel_err=errs,
          tree_plans_and_replans=counts)
    if max(errs.values()) > PARITY_TOL or counts[0] != counts[1]:
        raise RuntimeError(f"mfv_parity: kernel path disagrees with the "
                           f"plain path: {errs} {counts}")


def mfv_main_path(dev, card):
    """mfv_box at full size: setup, warm-up, the post-warm-up replan, the
    timed window of one rebuild cadence, then the checks and the kernels
    against their plain versions at the path's shapes.  Returns the
    path's launch counts and the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_mfv_kernels,
                                         mfv_gravity_accuracy)

    sim, ic = make_mfv_sim(N_MAIN, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    m0 = sim.state.m.clone()
    run_timed(sim, STEPS_WARM)
    # the post-warm-up replan at the live timestep, then re-warm
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    e0 = mfv_energy(sim.state)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, MFV_STEPS_TIMED)
    launches = {k: _ext.LAUNCHES[k] for k in MFV}
    done = sim.Nsteps - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replans = sim._n_grid_overflows - replans0
    s = sim.state
    N = s.N
    drift = abs(mfv_energy(s) - e0) / abs(e0)
    acc = mfv_gravity_accuracy(sim, n_sample=2048)
    every_step = {k: launches[k] >= (2 * done if k == "grid27_bin"
                                     else done) for k in MFV}
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "Qcons0",
                                "grad", "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(every_step.values()),
        "mass_exact": bool(torch.equal(s.m, m0)),
        "accuracy": acc["rms_rel_err"] <= ACCURACY_TOL,
        "energy_drift": drift <= MFV_ENERGY_DRIFT_TOL,
    }
    rep = compare_mfv_kernels(sim, s, repeats=5)
    spec = sim.treespec
    RATES["mfv"] = N * done / elapsed
    phase("mfv_main_path", N=N, steps=sim.Nsteps, timed_steps=done,
          setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * done / elapsed,
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=sim.timing.totals.get("TREE_REBUILD", 0.0)
          - rebuild0, replans_in_window=replans, G_pad=spec.n_leaves,
          near_cap=spec.near_cap, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, launches=launches,
          energy_drift=drift, energy_gate=MFV_ENERGY_DRIFT_TOL,
          accuracy=acc, accuracy_gate=ACCURACY_TOL,
          bad_gradients=int(s.bad_grad.sum()), checks=checks, kernels=rep,
          card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"mfv main path checks failed: {failed}")
    names = ("mfv_density", "mfv_gradients", "mfv_fluxes", "tree_near_mfv")
    return ({k: launches[k] for k in names}, {k: rep[k] for k in names})


def make_nbody_sim(n_star, device, dtype=torch.float64, **overrides):
    from gandalf_tpu_torch.check import nbody_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    return SimulationBase.factory(nbody_params(n_star, **overrides), device,
                                  dtype)


def nbody_kernels(dev) -> None:
    """K13-K15 against their plain versions on the card."""
    from gandalf_tpu_torch.check import (compare_nbody_kernels,
                                         nbody_kernel_inputs)

    for n in NBODY_KERNEL_SIZES:
        for dtype in (torch.float64, torch.float32):
            (r, v, m, h), kern = nbody_kernel_inputs(n, dev, dtype)
            rep = compare_nbody_kernels(r, v, m, h, kern)
            phase("nbody_kernels", N=n, ndim=r.shape[1], dtype=str(dtype),
                  report=rep)
            require_ok("nbody_kernels", rep)


def nbody_parity(dev) -> None:
    """10 float64 steps of a 1,024-star plummer_cluster, softened under
    hermite4 and unsoftened under hermite6ts, kernels on the card against
    the plain path on the CPU."""
    for scheme, soft in (("hermite4", 1), ("hermite6ts", 0)):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = make_nbody_sim(NBODY_PARITY_N, device, nbody=scheme,
                                 nbody_softening=soft)
            sim.SetupSimulation()
            for _ in range(NBODY_PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        errs = parity_errors(sims, ("r", "v", "a", "adot", "a2dot", "gpot"))
        errs["dt"] = abs(sims[0]._dt_host - sims[1]._dt_host) \
            / sims[1]._dt_host
        phase("nbody_parity", N=NBODY_PARITY_N, scheme=scheme,
              softening=soft, steps=NBODY_PARITY_STEPS, rel_err=errs)
        if max(errs.values()) > PARITY_TOL:
            raise RuntimeError(f"nbody_parity: kernel path disagrees with "
                               f"the plain path: {scheme} {errs}")


def run_nbody_path(sim, warm, timed, names):
    """Setup, `warm` steps, then `timed` steps with the launch counts set
    to 0 just before them.  Returns the phase's common fields."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import nbody_energy

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    for _ in range(warm):
        sim.main_loop_step()
    e0, t_sim0 = nbody_energy(sim.state), sim.t
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed):
        sim.main_loop_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s, N = sim.state, sim.state.N
    return {
        "N": N, "scheme": sim.scheme, "softening": int(sim.softening),
        "dtype": str(s.r.dtype), "steps": sim.Nsteps, "timed_steps": timed,
        "setup_s": t_setup, "ic_s": sim.timing.totals.get("GENERATE_IC",
                                                          0.0),
        "timed_s": elapsed, "steps_per_s": timed / elapsed,
        "star_steps_per_s": N * timed / elapsed,
        "pair_interactions_per_s": N * N * timed / elapsed,
        "sim_time_per_wall_s": (sim.t - t_sim0) / elapsed,
        "dt": sim._dt_host, "t": sim.t, "launches": launches,
        "energy_drift": abs(nbody_energy(s) - e0) / abs(e0),
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "adot", "a2dot", "gpot")),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def nbody_main_path(dev, card, variant=None, tag="nbody_main_path"):
    """plummer_cluster at 65,536 stars in float64, then K14 against its
    plain version at the path's state.  With `variant` the stars are
    softened with that smoothing kernel: K14 launches (and is compared)
    under its family name, never under M4's.  Returns the path's launch
    counts and the kernel reports."""
    from gandalf_tpu_torch.check import compare_nbody_kernels
    from gandalf_tpu_torch.kernels.smoothing import VARIANTS

    t_phase = time.perf_counter()
    over = {}
    if variant is not None:
        name, tab = VARIANTS[variant]
        over = {"kernel": name, "tabulated_kernel": tab}
    sim = make_nbody_sim(NBODY_N, dev, **over)
    k14 = "direct_softened" if variant is None \
        else f"direct_softened_{variant}"
    names = tuple(dict.fromkeys(NBODY + (k14,)))
    out = run_nbody_path(sim, NBODY_STEPS_WARM, NBODY_STEPS_TIMED, names)
    launches = out["launches"]
    want = {k: 0 for k in names}
    want[k14] = NBODY_STEPS_TIMED
    checks = {
        "finite": out["finite"],
        "launches": launches == want,
        "energy_drift": out["energy_drift"] <= NBODY_ENERGY_DRIFT_TOL,
    }
    s = sim.state
    rep = compare_nbody_kernels(s.r, s.v, s.m, s.h, sim.kern, repeats=3,
                                which=("direct_softened",))
    phase(tag, **out, kernel=sim.kern.variant,
          energy_gate=NBODY_ENERGY_DRIFT_TOL, checks=checks, kernels=rep,
          card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    return {k14: launches[k14]}, rep


def nbody_ts6_path(dev, card):
    """hermite6ts, unsoftened, at 16,384 stars: K13 and K15 twice a step
    (P(EC)^2), then both against their plain versions at the path's
    shapes.  Returns the path's launch counts and the kernel reports."""
    from gandalf_tpu_torch.check import compare_nbody_kernels

    sim = make_nbody_sim(NBODY_TS6_N, dev, nbody="hermite6ts",
                         nbody_softening=0)
    out = run_nbody_path(sim, NBODY_STEPS_WARM, NBODY_TS6_STEPS_TIMED,
                         NBODY)
    launches = out["launches"]
    twice = 2 * NBODY_TS6_STEPS_TIMED
    checks = {
        "finite": out["finite"],
        "launches": launches == {"direct_nbody": twice,
                                 "direct_softened": 0,
                                 "direct_snap": twice},
    }
    s = sim.state
    rep = compare_nbody_kernels(s.r, s.v, s.m, s.h, None, repeats=3,
                                which=("direct_nbody", "direct_snap"))
    phase("nbody_ts6_path", **out, checks=checks, kernels=rep, card=card)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"nbody hermite6ts path checks failed: {failed}")
    names = ("direct_nbody", "direct_snap")
    return ({k: launches[k] for k in names}, {k: rep[k] for k in names})


def make_ewald_sim(kind, n_side, device, dtype, ntreebuildstep=None):
    """A simulation with the Ewald sum: the Jeans box ("jeans"), the slab
    ("slab", open along z), the cylinder ("cylinder", periodic along z
    only), each through GradhSphSimulation, or the MFV box with ewald = 1
    ("mfv").  Returns (sim, ic or None)."""
    from gandalf_tpu_torch.check import (jeans_params, jittered_box_ic,
                                         mfv_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    ic = None
    if kind == "mfv":
        p = mfv_params(n_side, self_gravity=1)
        p.set("ewald", 1)
        ic = jittered_box_ic(p, n_side)
    else:
        p = jeans_params(n_side)
        if kind != "jeans":
            per = "xy" if kind == "slab" else "z"
            p.set("ic", "ewaldslab" if kind == "slab" else "ewaldcylinder")
            for k, axis in enumerate("xyz"):
                p.set(f"boxmin[{k}]", -0.5)
                p.set(f"boxmax[{k}]", 0.5)
                side = "periodic" if axis in per else "open"
                p.set(f"boundary_lhs[{k}]", side)
                p.set(f"boundary_rhs[{k}]", side)
    if ntreebuildstep is not None:
        p.set("ntreebuildstep", ntreebuildstep)
    return SimulationBase.factory(p, device, dtype), ic


def ewald_kernels(dev) -> None:
    """K6 and K7 in their Ewald mode against their plain versions on the
    card, after setup, for each periodicity and the MFV zeta mode."""
    from gandalf_tpu_torch.check import compare_tree_kernels

    for n_side in EWALD_SIZES:
        for dtype in (torch.float64, torch.float32):
            for kind in ("jeans", "slab", "cylinder", "mfv"):
                sim, ic = make_ewald_sim(kind, n_side, dev, dtype)
                sim.SetupSimulation(ic)
                rep = compare_tree_kernels(sim, sim.state)
                phase("ewald_kernels", kind=kind, n_side=n_side,
                      dtype=str(dtype), far_kind=sim.ewald_table.far_kind,
                      G=sim.treespec.n_leaves,
                      near_cap=sim.treespec.near_cap, report=rep)
                require_ok("ewald_kernels", rep)


def tree_option_kernels(dev) -> None:
    """K6 with each accuracy MAC and K6/K7 with the fast multipoles
    against their plain versions on the card, over all groups and over
    a list of every other group, after setup and 2 steps of the
    self-gravitating box (so that a0 and gpot are set)."""
    from gandalf_tpu_torch.check import compare_tree_kernels

    for n_side in EWALD_SIZES:
        for dtype in (torch.float64, torch.float32):
            for key, value in OPTIONS + (("multipole", "fast_monopole"),):
                sim, ic = make_sim(n_side, dev, dtype, self_gravity=1)
                sim.params.set(key, value)
                sim.SetupSimulation(ic)
                sim.main_loop_steps(2)
                rep = compare_tree_kernels(sim, sim.state, listed=True)
                phase("tree_option_kernels", option=value, n_side=n_side,
                      dtype=str(dtype), G=sim.treespec.n_leaves,
                      near_cap=sim.treespec.near_cap, report=rep)
                require_ok("tree_option_kernels", rep)


def ewald_parity(dev) -> None:
    """EWALD_PARITY_STEPS float64 steps at 16^3 with the Ewald sum,
    kernels on the card against the plain path on the CPU, with a tree
    rebuild every 2 steps: the same fields within PARITY_TOL and the same
    plans."""
    for kind in ("jeans", "slab", "cylinder", "mfv"):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim, ic = make_ewald_sim(kind, EWALD_PARITY_N, device,
                                     torch.float64,
                                     ntreebuildstep=GRAVITY_NTB_PARITY)
            sim.SetupSimulation(ic)
            for _ in range(EWALD_PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        fields = ("r", "v", "u", "h", "rho", "gpot") + (
            ("m", "Qcons0") if kind == "mfv" else ())
        errs = parity_errors(sims, fields)
        counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
        phase("ewald_parity", kind=kind, n_side=EWALD_PARITY_N,
              steps=EWALD_PARITY_STEPS,
              rel_err=errs, tree_plans_and_replans=counts)
        if max(errs.values()) > PARITY_TOL or counts[0] != counts[1]:
            raise RuntimeError(f"ewald_parity: kernel path disagrees with "
                               f"the plain path: {kind} {errs} {counts}")


def ewald_main_path(dev, card):
    """ewald_jeans_box at full size: the host table's build time, setup,
    warm-up, the post-warm-up replan, the timed window of one rebuild
    cadence, then the checks and the kernels against their plain
    versions at the path's shapes.  Returns the path's launch counts and
    the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_kernels,
                                         compare_tree_kernels,
                                         periodic_gravity_accuracy)
    from gandalf_tpu_torch.ops.ewald import build_ewald_table

    sim, _ = make_ewald_sim("jeans", N_MAIN, dev, torch.float32)
    p = sim.params
    t0 = time.perf_counter()
    build_ewald_table([1.0] * 3, ngrid=max(p.intparams["nEwaldGrid"], 9),
                      ewald_mult=p.floatparams["ewald_mult"])
    table_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    boot_replans = sim._n_grid_overflows
    run_timed(sim, STEPS_WARM)
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    e0 = energy(sim.state, gravity=True)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, EWALD_STEPS_TIMED)
    done = sim.Nsteps - steps0
    launches = {k: _ext.LAUNCHES[k] for k in EWALD}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replans = sim._n_grid_overflows - replans0
    s = sim.state
    N = s.N
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    acc = periodic_gravity_accuracy(sim, n_sample=2048)
    # the same walk without the correction: the gate must reject it
    plain_acc = periodic_gravity_accuracy(sim, n_sample=2048, ewald=False)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= done for n in launches.values()),
        "accuracy": acc["rms_rel_err"] <= EWALD_ACCURACY_TOL,
        "gate_rejects_no_ewald": plain_acc["rms_rel_err"]
        > EWALD_ACCURACY_TOL,
        "energy_drift": drift <= GRAVITY_ENERGY_DRIFT_TOL,
    }
    rep = compare_kernels(sim, s, repeats=5, quiet=True)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    spec = sim.treespec
    phase("ewald_main_path", N=N, steps=sim.Nsteps, timed_steps=done,
          table_build_s=table_s, table_nodes=list(
              sim.ewald_table.pot.shape), setup_s=t_setup,
          bootstrap_replans=boot_replans, timed_s=elapsed,
          particle_steps_per_s=N * done / elapsed,
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=sim.timing.totals.get("TREE_REBUILD", 0.0)
          - rebuild0, replans_in_window=replans, G_pad=spec.n_leaves,
          near_cap=spec.near_cap, support_cap=spec.support_cap,
          frontier_levels=list(spec.frontier_levels),
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, energy_drift=drift,
          energy_gate=GRAVITY_ENERGY_DRIFT_TOL, accuracy=acc,
          accuracy_without_ewald=plain_acc, accuracy_gate=EWALD_ACCURACY_TOL,
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"ewald main path checks failed: {failed}")
    names = ("tree_walk_ewald", "tree_near_ewald")
    return ({k: launches[k] for k in names}, {k: rep[k] for k in names})


def tree_options_path(dev, card):
    """The self-gravitating box at full size with each option in turn:
    setup, warm-up, the post-warm-up replan, the timed steps, then the
    accuracy against the direct sum beside the geometric MAC's, and K6
    and K7 against their plain versions at the path's shapes.  Returns
    the paths' launch counts and the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_tree_kernels,
                                         gravity_accuracy)

    out_launches, out_rep = {}, {}
    for key, value in OPTIONS:
        sim, ic = make_sim(N_MAIN, dev, torch.float32, self_gravity=1)
        sim.params.set(key, value)
        t0 = time.perf_counter()
        sim.SetupSimulation(ic)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        boot_replans = sim._n_grid_overflows
        boot_near_cap = sim.treespec.near_cap
        run_timed(sim, STEPS_WARM)
        sim._plan_tree_buckets(sim.state.r.cpu().numpy())
        replans0 = sim._n_grid_overflows
        steps0 = sim.Nsteps
        wname, nname = _ext.launch_names(sim.treespec)
        _ext.reset_launches()
        elapsed = run_timed(sim, OPTIONS_STEPS_TIMED)
        done = sim.Nsteps - steps0
        names = HYDRO + ("tree_gather", "tree_build", wname, nname)
        launches = {k: _ext.LAUNCHES[k] for k in names}
        replans = sim._n_grid_overflows - replans0
        s = sim.state
        spec = sim.treespec
        acc = gravity_accuracy(sim, n_sample=2048)
        geo = gravity_accuracy(sim, n_sample=2048, spec=dataclasses.replace(
            spec, mac="geometric", fast=False))
        checks = {
            "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                          for f in ("r", "v", "a", "u", "h", "rho",
                                    "gpot")),
            "rho_positive": bool((s.rho > 0).all()),
            "no_overflow": not bool(s.neib_overflow)
            and not acc["overflow"],
            "launches": all(n >= done for n in launches.values()),
            "accuracy": (acc["rms_rel_err"] <= FAST_ACCURACY_TOL
                         if spec.fast else acc["rms_rel_err"]
                         <= MAC_ERROR_RATIO * geo["rms_rel_err"]),
        }
        # K7 runs in its own mode under an accuracy MAC, the mode the
        # gravity path holds; its plain version at whole-tree near lists
        # would take minutes
        rep = compare_tree_kernels(sim, s, repeats=5, near=spec.fast)
        phase("tree_options_path", option=value, N=s.N, steps=sim.Nsteps,
              timed_steps=done, setup_s=t_setup,
              bootstrap_replans=boot_replans,
              bootstrap_near_cap=boot_near_cap, timed_s=elapsed,
              particle_steps_per_s=s.N * done / elapsed,
              replans_in_window=replans, G_pad=spec.n_leaves,
              near_cap=spec.near_cap, frontier_levels=list(
                  spec.frontier_levels), launches=launches, accuracy=acc,
              geometric_accuracy=geo, checks=checks, kernels=rep, card=card)
        failed = [k for k, ok in checks.items() if not ok]
        failed += [k for k, r in rep.items() if not r["ok"]]
        if failed:
            raise RuntimeError(f"tree options path ({value}) checks "
                               f"failed: {failed}")
        keep = (wname, nname) if spec.fast else (wname,)
        out_launches.update({k: launches[k] for k in keep})
        out_rep.update({k: rep[k] for k in keep})
        del sim, s
    return out_launches, out_rep


def sink_kernels(dev) -> None:
    """K16-K18 against their plain versions on synthetic inputs with the
    edge cases, in float64 and float32; at the embedded cluster's size
    also timed in float32."""
    from gandalf_tpu_torch.check import (bound, compare_sink_kernels,
                                         sink_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory

    kern = kernel_factory("m4", 3)
    for n, ns in SINK_KERNEL_SIZES + (SINK_CLUSTER,):
        for dtype in (torch.float64, torch.float32):
            cluster = (n, ns) == SINK_CLUSTER and dtype == torch.float32
            rep = compare_sink_kernels(
                kern, sink_kernel_inputs(n, ns, dev, dtype),
                repeats=3 if cluster else 0)
            if cluster:
                for r in rep.values():
                    r["bound_ms"], r["bound_by"] = bound(r["work"], dtype)
            phase("sink_kernels", N=n, Ns=ns, dtype=str(dtype), report=rep)
            require_ok("sink_kernels", rep)


def _sink_run(make, device, steps):
    """A float64 sink simulation from make(device) after setup and
    `steps` single steps, with its active slots and alive mask after
    each step."""
    sim = make(device)
    sim.SetupSimulation()
    trail = []
    for _ in range(steps):
        sim.main_loop_step()
        trail.append((sim.state.sinks.active.cpu().clone(),
                      sim.state.alive.cpu().clone()))
    return sim, trail


def sink_parity(dev) -> None:
    """Sink runs in float64, kernels on the card against the plain path
    on the CPU: equal sinks created at equal steps, equal eaten gas,
    equal tree plans, and every field within PARITY_TOL."""
    from gandalf_tpu_torch.check import bb_params
    from gandalf_tpu_torch.params import Parameters
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    def bb(device):
        p = bb_params(SINK_PARITY_BB_N, rho_sink=BB_RHO_SINK)
        p.set("particle_distribution", "random")
        p.set("rand_algorithm", "default")
        return GradhSphSimulation(p, device=device, dtype=torch.float64)

    def plummer(device):
        p = Parameters()
        n_gas, n_star = SINK_PARITY_PLUMMER
        for k, v in dict(run_id="", sim="sph", ndim=3, ic="plummer",
                         Nhydro=n_gas, Nstar=n_star, gasfrac=0.5,
                         starfrac=0.5, self_gravity=1, dimensionless=1,
                         gas_eos="energy_eqn", neib_search="kdtree",
                         sink_particles=1, create_sinks=0,
                         tsnapfirst=1e30).items():
            p.set(k, v)
        return GradhSphSimulation(p, device=device, dtype=torch.float64)

    for tag, make, steps in (("bb_random", bb, SINK_PARITY_BB_STEPS),
                             ("hybrid_plummer", plummer,
                              SINK_PARITY_PLUMMER_STEPS)):
        runs = [_sink_run(make, d, steps) for d in (dev, torch.device("cpu"))]
        sims = [r[0] for r in runs]
        torch.cuda.synchronize()
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot"))
        for f in ("r", "v", "m", "mdot"):
            x = getattr(sims[0].state.sinks, f).cpu()
            ref = getattr(sims[1].state.sinks, f)
            errs[f"sink_{f}"] = float(torch.abs(x - ref).max()
                                      / torch.abs(ref).max().clamp_min(1e-300))
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(runs[0][1], runs[1][1]))
        counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
        created = [int(t[0].sum()) for t in runs[1][1]]
        phase("sink_parity", run=tag, N=sims[1].state.N, steps=steps,
              rel_err=errs, same_sinks_and_eaten_each_step=same,
              active_slots_per_step=created,
              dead=int((~sims[1].state.alive).sum()),
              tree_plans_and_replans=counts)
        if max(errs.values()) > PARITY_TOL or not same \
                or counts[0] != counts[1]:
            raise RuntimeError(f"sink_parity: kernel path disagrees with "
                               f"the plain path: {tag} {errs} {counts}")


def _family_names(names, kern):
    """`names` with the kernels that take the smoothing-kernel family
    (FAMILY_KERNELS, K14, K16, K20) under `kern`'s family names, each
    beside its dims suffix (grid27_density_2d: grid27_density_quintic_2d),
    as _ext.family_count and tree_count form them."""
    from gandalf_tpu_torch import _ext

    out = []
    for k in names:
        base, dims = (k[:-3], k[-3:]) if k.endswith(("_2d", "_1d")) \
            else (k, "")
        if base in FAMILY_KERNELS + SINK_FAMILY:
            base = _ext.family_count(base, kern)
        out.append(base + dims)
    return tuple(out)


def bb_sink_collapse(dev, card, variant=None, tag="bb_sink_collapse"):
    """bb_sink_collapse at full size: setup, the timed window straight
    after the bootstrap, then the checks and the kernels against their
    plain versions at the path's state.  With `variant` the run takes
    that smoothing kernel: K2, K3, K7, K14 and K16 launch under their
    family names and never under M4's (no_m4_launch), and the same
    comparisons hold K4-K7 and K16-K18 at the path's state.  Returns the
    path's launch counts, the kernel reports and K4's alive mode (with
    `variant`, K16's count and report and no alive mode)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bb_params, compare_sink_kernels,
                                         compare_tree_kernels, family_params,
                                         gravity_accuracy, ledger_errors,
                                         sim_sink_inputs, sink_ledger,
                                         total_mass)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = bb_params(BB_N, rho_sink=BB_RHO_SINK)
    if variant is not None:
        family_params(variant, params)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    s = sim.state
    boot = {"replans": sim._n_grid_overflows, "N": s.N,
            "ncells": list(sim.gridspec.ncells),
            "k_cell": sim.gridspec.k_cell,
            "rho_mean": float(s.rho.double().mean()),
            "rho_max": float(s.rho.max()),
            "rho_sink_code": sim.sink_cfg.rho_sink,
            "sound_code": float(s.sound.double().mean()),
            "rho_code_in_g_cm3": sim.units.rho.outscale}
    mass0 = total_mass(sim)
    sinks0 = int(s.sinks.active.sum())
    margin = compare_sink_kernels(sim.kern, sim_sink_inputs(sim),
                                  which=("sink_candidate",))[
        "sink_candidate"]["top_two_margin"]
    rows = sink_ledger(sim)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    replan0 = sim.timing.totals.get("GRID_REPLAN", 0.0)
    steps0 = sim.Nsteps
    bb, sink = _family_names(BB, sim.kern), _family_names(SINK, sim.kern)
    _ext.reset_launches()
    elapsed = run_timed(sim, BB_STEPS_TIMED)
    done = sim.Nsteps - steps0
    launches = {k: _ext.LAUNCHES[k] for k in bb}
    m4_launches = {k: _ext.LAUNCHES[k] for k in BB if k not in bb}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replans = sim._n_grid_overflows - replans0
    s = sim.state
    st = s.sinks
    alive = s.alive
    mass1 = total_mass(sim)
    # steps run, a burst redone after an overflow replan included
    steps_run = len(rows)
    em, ep, m_dead = ledger_errors(rows)
    del rows
    acc = gravity_accuracy(sim, n_sample=2048)
    dead = ~alive
    act = st.active
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[alive]).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "gpot"))
        and all(bool(torch.isfinite(getattr(st, f)[act]).all())
                for f in ("r", "v", "a", "m")),
        "rho_positive": bool((s.rho[alive] > 0).all()),
        "sinks_formed": int(act.sum()) - sinks0 >= BB_MIN_SINKS,
        "dead_at_rest": bool((s.m[dead] == 0).all())
        and bool((s.v[dead] == 0).all()) and bool((s.a[dead] == 0).all()),
        "mass_conserved": abs(mass1 - mass0) / mass0 <= BB_MASS_TOL,
        "ledger": len(em) >= done and max(em + ep) <= BB_LEDGER_TOL,
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= done for n in launches.values()),
        "sink_kernels_once_a_step": all(launches[k] == steps_run
                                        for k in sink),
        "accuracy": acc["rms_rel_err"] <= BB_ACCURACY_TOL,
    }
    rep = compare_sink_kernels(sim.kern, sim_sink_inputs(sim), repeats=5)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    if variant is not None:
        checks["no_m4_launch"] = not any(m4_launches.values())
    spec = sim.treespec
    phase(tag, kernel=sim.kern.variant, steps=sim.Nsteps, timed_steps=done,
          steps_run=steps_run, setup_s=t_setup, bootstrap=boot,
          timed_s=elapsed,
          particle_steps_per_s=s.N * done / elapsed,
          t_code=sim.t, dt_code=float(s.dt),
          sinks_active=int(act.sum()), sinks_formed=int(act.sum()) - sinks0,
          dead=int(dead.sum()), sink_masses=st.m[act].tolist(),
          top_two_rho_margin_at_bootstrap=margin,
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=sim.timing.totals.get("TREE_REBUILD", 0.0)
          - rebuild0, replans_in_window=replans,
          replan_host_s=sim.timing.totals.get("GRID_REPLAN", 0.0) - replan0,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          G_pad=spec.n_leaves, near_cap=spec.near_cap,
          support_cap=spec.support_cap, launches=launches,
          mass_rel_change=abs(mass1 - mass0) / mass0,
          ledger_mass_err=max(em), ledger_momentum_err=max(ep),
          dead_mass_per_step=m_dead, accuracy=acc,
          accuracy_gate=BB_ACCURACY_TOL, checks=checks, kernels=rep,
          card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    if variant is not None:
        k16 = sink[0]
        return {k16: launches[k16]}, {k16: rep[k16]}, None
    k4 = rep["tree_gather"]
    alive_mode = {"path": "bb_sink_collapse",
                  "launches": launches["tree_gather"],
                  "dead": k4["dead"], "max_abs_err": k4["max_abs_err"],
                  "ms": k4["ms"], "plain_ms": k4["plain_ms"]}
    names = SINK[:3]
    return ({k: launches[k] for k in names}, {k: rep[k] for k in names},
            alive_mode)


def bb_published(dev, card) -> None:
    """The published bossbodenheimer.dat (only Nhydro, the snapshot
    times and run_id changed) for a few steps: no sink forms."""
    from gandalf_tpu_torch.check import bb_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    sim = GradhSphSimulation(bb_params(BB_N), device=dev,
                             dtype=torch.float32)
    sim.SetupSimulation()
    elapsed = run_timed(sim, BB_PUBLISHED_STEPS)
    s = sim.state
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "gpot")),
        "no_sink": not bool(s.sinks.active.any()),
        "all_alive": bool(s.alive.all()),
        "no_overflow": not bool(s.neib_overflow),
    }
    phase("bb_published", N=s.N, steps=sim.Nsteps, timed_s=elapsed,
          particle_steps_per_s=s.N * sim.Nsteps / elapsed,
          rho_max_over_rho_sink=float(s.rho.max()) / sim.sink_cfg.rho_sink,
          checks=checks, card=card)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"bb_published checks failed: {failed}")


def make_dims_sim(case, device, dtype):
    """A controller and its IC for the 1D and 2D phases: "sod" (the Sod
    tube at 512 + 128), "sod_mirror" (the same between mirror walls),
    "khi_small" (the KHI at 32x16 + 48x24), "khi" (at full width) or a
    mirror layout ("dim0", "mixed" at `MIRROR_KERNEL_N`^3, "column" the
    1D mirror column of 64), with its IC (None: the generated one)."""
    from gandalf_tpu_torch.check import (MIRROR_DIM0, MIRROR_MIXED,
                                         khi_params, mirror_ic,
                                         mirror_params, sod_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    ic = None
    if case == "sod":
        params = sod_params()
    elif case == "sod_mirror":
        params = sod_params(mirror=True)
    elif case == "khi_small":
        params = khi_params(1)
    elif case == "khi":
        params = khi_params(KHI_SCALE)
    else:
        ndim, n, walls = {
            "dim0": (3, MIRROR_KERNEL_N, MIRROR_DIM0),
            "mixed": (3, MIRROR_KERNEL_N, MIRROR_MIXED),
            "dim0_parity": (3, MIRROR_PARITY_N, MIRROR_DIM0),
            "mixed_parity": (3, MIRROR_PARITY_N, MIRROR_MIXED),
            "dim0_main": (3, MIRROR_N, MIRROR_DIM0),
            "mixed_main": (3, MIRROR_N, MIRROR_MIXED),
            "column": (1, 64, MIRROR_DIM0)}[case]
        params = mirror_params(n, ndim, walls)
        ic = mirror_ic(params, walls)
    return GradhSphSimulation(params, device=device, dtype=dtype), ic


def dims_kernels(dev) -> None:
    """K1-K3 at ndim 1 and 2 against their plain versions on the card:
    the Sod tube (512 + 128) and the small KHI, float64 and float32."""
    from gandalf_tpu_torch.check import compare_kernels

    t0 = time.perf_counter()
    for case in ("sod", "khi_small"):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_dims_sim(case, dev, dtype)
            sim.SetupSimulation(ic)
            rep = compare_kernels(sim, sim.state)
            phase("dims_kernels", case=case, ndim=sim.ndim, N=sim.state.N,
                  dtype=str(dtype), ncells=list(sim.gridspec.ncells),
                  k_cell=sim.gridspec.k_cell, report=rep)
            require_ok("dims_kernels", rep)
    phase("dims_kernels_done", seconds=time.perf_counter() - t0)


def mirror_kernels(dev) -> None:
    """K19, K1 with its discard mask, and K2/K3 on the extended set
    against their plain versions on the card: both wall layouts at 16^3
    and the 1D mirror column, float64 and float32."""
    from gandalf_tpu_torch.check import compare_mirror_kernels

    t0 = time.perf_counter()
    for case in ("dim0", "mixed", "column"):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_dims_sim(case, dev, dtype)
            sim.SetupSimulation(ic)
            rep = compare_mirror_kernels(sim, sim.state)
            phase("mirror_kernels", layout=case, ndim=sim.ndim,
                  N=sim.state.N, dtype=str(dtype),
                  ncells=list(sim.gridspec.ncells),
                  k_cell=sim.gridspec.k_cell, report=rep)
            require_ok("mirror_kernels", rep)
    phase("mirror_kernels_done", seconds=time.perf_counter() - t0)


def dims_parity(dev) -> None:
    """5 float64 steps of the Sod tube, the small KHI, both mirror layouts
    at 8^3 and the 1D mirror column, kernels on the card against the
    plain path on the CPU: fields within PARITY_TOL, equal grid plans."""
    t0 = time.perf_counter()
    for case in ("sod", "khi_small", "dim0_parity", "mixed_parity",
                 "column"):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim, ic = make_dims_sim(case, device, torch.float64)
            sim.SetupSimulation(ic)
            for _ in range(PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho"))
        same_plan = sims[0].gridspec == sims[1].gridspec
        phase("dims_parity", case=case, ndim=sims[0].ndim,
              N=sims[0].state.N, steps=PARITY_STEPS, rel_err=errs,
              same_grid_plan=same_plan,
              replans=[s._n_grid_overflows for s in sims])
        if max(errs.values()) > PARITY_TOL or not same_plan:
            raise RuntimeError(f"dims_parity: kernel path disagrees with "
                               f"the plain path: {case} {errs}")
    phase("dims_parity_done", seconds=time.perf_counter() - t0)


def momentum(s):
    """Sum m v in float64 (a host vector) and sum m |v|."""
    mv = s.m.double()[:, None] * s.v.double()
    return (torch.sum(mv, dim=0).cpu().numpy(),
            float(torch.sum(torch.linalg.vector_norm(mv, dim=-1))))


def khi_main_path(dev, card):
    """khi_main_path at full width (check.khi_params, 425,984 particles,
    float32): setup, 2 warm-up steps, then 32 timed steps with the counts
    set to 0 just before them; the gates, and K1-K3 (2D) against their
    plain versions at the path's state.  Returns the launches and the
    kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_kernels, mapping_times

    t_phase = time.perf_counter()
    sim, _ = make_dims_sim("khi", dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, KHI_STEPS_WARM)
    e0 = energy(sim.state)
    p0, _ = momentum(sim.state)
    replans0 = sim._n_grid_overflows
    _ext.reset_launches()
    elapsed = run_timed(sim, KHI_STEPS_TIMED)
    names = [f"{k}_2d" for k in HYDRO]
    launches = {k: _ext.LAUNCHES[k] for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    drift = abs(energy(s) - e0) / abs(e0)
    p1, mv = momentum(s)
    dp = float(np.abs(p1 - p0).max()) / mv
    rho = s.rho.double()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= KHI_STEPS_TIMED for n in launches.values()),
        "energy_drift": drift < ENERGY_DRIFT_TOL,
        "contrast": float(rho.min()) < 1.3 and float(rho.max()) > 1.6,
    }
    rep = compare_kernels(sim, s, repeats=5)
    mapping = mapping_times(sim, s)
    phase("khi_main_path", N=N, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, steps=sim.Nsteps,
          timed_steps=KHI_STEPS_TIMED, setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * KHI_STEPS_TIMED / elapsed,
          t_code=sim.t, dt_code=float(s.dt),
          replans_in_window=sim._n_grid_overflows - replans0,
          grid_replans=sim._n_grid_overflows, launches=launches,
          energy_drift=drift, momentum_change_over_sum_m_abs_v=dp,
          rho_min=float(rho.min()), rho_max=float(rho.max()),
          checks=checks, kernels=rep, slot_mappings=mapping, card=card,
          peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    RATES["khi_main_path"] = N * KHI_STEPS_TIMED / elapsed
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"khi_main_path checks failed: {failed}")
    return launches, rep


def khi_published(dev, card) -> None:
    """GANDALF's examples/khi.dat as written (no snapshots, no run id),
    8 steps on the card: every field finite."""
    from gandalf_tpu_torch.check import mapping_times, published_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    sim = SimulationBase.factory(published_params("khi"), dev)
    sim.SetupSimulation()
    elapsed = run_timed(sim, KHI_PUBLISHED_STEPS)
    s = sim.state
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho")),
        "no_overflow": not bool(s.neib_overflow),
    }
    phase("khi_published", N=s.N, steps=sim.Nsteps, timed_s=elapsed,
          dtype=str(s.r.dtype), ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, checks=checks,
          slot_mappings=mapping_times(sim, s, repeats=20), card=card,
          seconds=time.perf_counter() - t0)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"khi_published checks failed: {failed}")


def sod_path(dev, card):
    """The Sod tube (512 + 128, float64 on the card) to t = 0.5: L1(vx)
    against the exact solution below 9e-3, periodic (the counts set to 0
    just before its run) and between mirror walls at +-2; then
    examples/adsod.dat as written to its tend, every field finite.
    Returns the periodic run's launches and its kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_kernels, mapping_times,
                                         published_params, sod_l1)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    out = {}
    launches = rep = None
    for case in ("sod", "sod_mirror"):
        sim, _ = make_dims_sim(case, dev, torch.float64)
        sim.SetupSimulation()
        if case == "sod":
            _ext.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.Run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if case == "sod":
            names = [f"{k}_1d" for k in HYDRO]
            launches = {k: _ext.LAUNCHES[k] for k in names}
            rep = compare_kernels(sim, sim.state, repeats=20)
            for r in rep.values():
                r["dtype"] = str(torch.float64)
            mapping = mapping_times(sim, sim.state, repeats=20)
        l1 = sod_l1(sim)
        out[case] = {"N": sim.state.N, "steps": sim.Nsteps, "t": sim.t,
                     "run_s": elapsed, "L1_vx": l1,
                     "walls": list(sim.gridspec.mirror),
                     "ncells": list(sim.gridspec.ncells),
                     "k_cell": sim.gridspec.k_cell,
                     "replans": sim._n_grid_overflows,
                     "ok": l1 < SOD_L1_GATE and abs(sim.t - 0.5) < 1e-12}
    sim = SimulationBase.factory(published_params("adsod"), dev)
    sim.SetupSimulation()
    sim.Run()
    s = sim.state
    out["adsod_dat"] = {
        "N": s.N, "steps": sim.Nsteps, "t": sim.t, "dtype": str(s.r.dtype),
        "ok": all(bool(torch.isfinite(getattr(s, f)).all())
                  for f in ("r", "v", "a", "u", "h", "rho"))
        and abs(sim.t - sim.params.floatparams["tend"]) < 1e-6}
    checks = {k: v["ok"] for k, v in out.items()}
    checks["launches"] = all(n >= out["sod"]["steps"]
                             for n in launches.values())
    phase("sod_path", runs=out, launches=launches, l1_gate=SOD_L1_GATE,
          checks=checks, kernels=rep, slot_mappings=mapping, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"sod_path checks failed: {failed}")
    return launches, rep


def mirror_box(dev, card):
    """mirror_box: both wall layouts of tests/test_grid_mirror.py at 64^3
    (jittered_state's IC, float32): setup, 2 warm-up steps, then 16 timed
    steps (the counts set to 0 just before them), bursts checked for
    particles beyond a wall; energy drift, finiteness, overflow; K19 and
    the mirror path's K1-K3 against their plain versions at the path's
    state.  Returns the dim-0 layout's K19 launches and report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_mirror_kernels, mapping_times

    t_phase = time.perf_counter()
    k19_launches = k19_rep = None
    for case in ("dim0_main", "mixed_main"):
        sim, ic = make_dims_sim(case, dev, torch.float32)
        t0 = time.perf_counter()
        sim.SetupSimulation(ic)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        run_timed(sim, MIRROR_STEPS_WARM)
        e0 = energy(sim.state)
        walls = sim.box.mirror_walls()
        _ext.reset_launches()
        beyond = 0
        elapsed = 0.0
        done = 0
        while done < MIRROR_STEPS_TIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done += sim.main_loop_steps(MIRROR_STEPS_TIMED - done)
            torch.cuda.synchronize()
            elapsed += time.perf_counter() - t0
            r = sim.state.r
            for (k, side) in walls:
                bound = (sim.box.boxmin[k] if side == 0
                         else sim.box.boxmax[k])
                out_ = r[:, k] < bound if side == 0 else r[:, k] > bound
                beyond += int(out_.sum())
        launches = {k: _ext.LAUNCHES[k] for k in HYDRO + ("grid27_mirror",)}
        s = sim.state
        drift = abs(energy(s) - e0) / abs(e0)
        checks = {
            "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                          for f in ("r", "v", "a", "u", "h", "rho", "dudt")),
            "rho_positive": bool((s.rho > 0).all()),
            "no_overflow": not bool(s.neib_overflow),
            "none_beyond_a_wall": beyond == 0,
            "launches": all(n >= MIRROR_STEPS_TIMED
                            for n in launches.values()),
            "energy_drift": drift < ENERGY_DRIFT_TOL,
        }
        rep = compare_mirror_kernels(sim, s, repeats=5)
        phase("mirror_box", layout=case, N=s.N, walls=list(walls),
              ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
              steps=sim.Nsteps, timed_steps=MIRROR_STEPS_TIMED,
              setup_s=t_setup, timed_s=elapsed,
              particle_steps_per_s=s.N * MIRROR_STEPS_TIMED / elapsed,
              grid_replans=sim._n_grid_overflows, launches=launches,
              energy_drift=drift, checks=checks, kernels=rep,
              slot_mappings=mapping_times(sim, s), card=card)
        failed = [k for k, ok in checks.items() if not ok]
        failed += [k for k, r in rep.items() if not r["ok"]]
        if failed:
            raise RuntimeError(f"mirror_box {case} checks failed: {failed}")
        if case == "dim0_main":
            k19_launches = {"grid27_mirror": launches["grid27_mirror"]}
            k19_rep = {"grid27_mirror": rep["grid27_mirror"]}
        del sim, s
    phase("mirror_box_done", seconds=time.perf_counter() - t_phase)
    return k19_launches, k19_rep


def _td_sim(case, device, dtype, scheme="cd2010"):
    """A simulation with time_dependent_avisc = `scheme` after setup and
    one step: "sod" (512 + 128), "khi_small" (32x16 + 48x24) or the box
    at `case`^3 (jittered, hydro only)."""
    from gandalf_tpu_torch.check import (jittered_box_ic, khi_params,
                                         slice_params, sod_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    ic = None
    if case == "sod":
        params = sod_params()
    elif case == "khi_small":
        params = khi_params(1)
    else:
        params = slice_params(case)
        ic = jittered_box_ic(params, case)
    params.set("time_dependent_avisc", scheme)
    sim = GradhSphSimulation(params, device=device, dtype=dtype)
    sim.SetupSimulation(ic)
    sim.main_loop_step()
    return sim


def td_sink_kernels(dev):
    """K20-K22 against their plain versions on the card in float64 and
    float32 (phase 35); K20 timed at the embedded cluster and K21 at the
    64^3 box in float32.  Returns K21's 3D report at the box."""
    from gandalf_tpu_torch.check import (bound, compare_td_sink_kernels,
                                         smooth_accretion_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.sinks import smooth_claims
    from gandalf_tpu_torch.state import FLAG_DEAD

    t0 = time.perf_counter()
    kern = kernel_factory("m4", 3)
    for n, ns in TD_SMOOTH_SIZES + (TD_CLUSTER,):
        for dtype in (torch.float64, torch.float32):
            cluster = (n, ns) == TD_CLUSTER
            if cluster and dtype == torch.float64:
                continue
            inputs = smooth_accretion_inputs(n, ns, dev, dtype)
            rep = compare_td_sink_kernels(kern, smooth_inputs=inputs,
                                          repeats=3 if cluster else 0)
            r = rep["smooth_accretion"]
            r["bound_ms"], r["bound_by"] = bound(r["work"], dtype)
            if not cluster:
                claim, _ = smooth_claims(inputs["cfg"], inputs["sinks"],
                                         inputs["r"], inputs["alive"])
                r["tie_to_lower_slot"] = int(claim[4]) == 2
                r["ok"] = r["ok"] and r["tie_to_lower_slot"] \
                    and r["whole"] > 0 and r["partial"] > 0
            phase("td_sink_kernels", kernel="K20", N=n, Ns=ns,
                  dtype=str(dtype), report=rep)
            require_ok("td_sink_kernels", rep)
    for case in ("sod", "khi_small") + TD_BOX_SIDES:
        for dtype in (torch.float64, torch.float32):
            sim = _td_sim(case, dev, dtype)
            s = sim.state
            if case == TD_BOX_SIDES[0]:
                # one particle whose support holds no neighbour: its rr is
                # singular and the switch takes alpha_visc (bad)
                s = s.replace(h=torch.where(
                    torch.arange(s.N, device=dev) == 0, 1e-3 * s.h, s.h))
            if case in TD_BOX_SIDES:
                rng = np.random.default_rng(case)
                lv = torch.as_tensor(rng.integers(0, 5, s.N),
                                     dtype=torch.int32, device=dev)
                dead = torch.as_tensor(rng.random(s.N) < 0.05, device=dev)
                s = s.replace(level=lv, flags=torch.where(
                    dead, s.flags | FLAG_DEAD, s.flags))
            rep = compare_td_sink_kernels(sim=sim, state=s)
            phase("td_sink_kernels", kernel="K21" + (
                "/K22" if "levelneib" in rep else ""), case=str(case),
                  ndim=sim.ndim, N=s.N, dtype=str(dtype), report=rep)
            require_ok("td_sink_kernels", rep)
            if case == TD_BOX_SIDES[0]:
                name = "cullen_dehnen"
                if rep[name]["bad"] < 1:
                    raise RuntimeError("td_sink_kernels: the singular "
                                       "neighbourhood did not set bad")
    for dtype in (torch.float64, torch.float32):
        sim = make_block_sim(BLOCK_PARITY_N, dev, dtype)
        sim.SetupSimulation()
        for _ in range(2):
            sim.main_loop_step()
        rep = compare_td_sink_kernels(sim=sim, state=sim.state)
        phase("td_sink_kernels", kernel="K22", case="cold_sphere_block",
              N=sim.state.N, dtype=str(dtype), report=rep)
        require_ok("td_sink_kernels", rep)
    sim = _td_sim(N_MAIN, dev, torch.float32)
    rep = compare_td_sink_kernels(sim=sim, state=sim.state, repeats=5)
    box = {"cullen_dehnen": rep["cullen_dehnen"]}
    for r in box.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], torch.float32)
    phase("td_sink_kernels", kernel="K21", case=f"box_{N_MAIN}",
          N=sim.state.N, dtype=str(torch.float32), report=box,
          seconds=time.perf_counter() - t0)
    require_ok("td_sink_kernels", box)
    return box


def block_sink_parity(dev):
    """Phase 36: float64, kernels on the card against the plain path on
    the CPU: the block-stepped hybrid Plummer sphere with smooth
    accretion and mm97 (equal levels, nlast, alive gas and tree plans
    on every tick, sink masses within PARITY_TOL), and the
    Boss-Bodenheimer cloud with cd2010 and smooth accretion.  Returns
    the card's K21 (3D) launches over the cloud's steps."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import bb_params, plummer_block_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    n_gas, n_star = SINK_PARITY_PLUMMER
    sims = []
    for device in (dev, torch.device("cpu")):
        sim = GradhSphSimulation(plummer_block_params(n_gas, n_star),
                                 device=device, dtype=torch.float64)
        sim.SetupSimulation()
        sims.append(sim)
    same, sink_err = True, 0.0
    for _ in range(BLOCK_SINK_PARITY_TICKS):
        for sim in sims:
            sim.main_loop_step()
        a, b = (x.state for x in sims)
        for f in ("level", "nlast", "alive"):
            same &= bool(torch.equal(getattr(a, f).cpu(), getattr(b, f)))
        same &= bool(torch.equal(a.sinks.active.cpu(), b.sinks.active))
        sink_err = max(sink_err, float(
            torch.abs(a.sinks.m.cpu() - b.sinks.m).max()
            / b.sinks.m.abs().max()))
    torch.cuda.synchronize()
    errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot", "alpha",
                                "m"))
    errs["sink_m"] = sink_err
    for f in ("r", "v", "angmom", "mdot"):
        x = getattr(sims[0].state.sinks, f).cpu()
        ref = getattr(sims[1].state.sinks, f)
        errs[f"sink_{f}"] = float(torch.abs(x - ref).max()
                                  / ref.abs().max().clamp_min(1e-300))
    counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
    s = sims[1].state
    m0 = float(s.m[s.alive].max())
    phase("block_sink_parity", run="plummer_block", N=s.N,
          ticks=BLOCK_SINK_PARITY_TICKS, rel_err=errs,
          same_levels_nlast_alive_each_tick=same,
          levels=torch.bincount(s.level).tolist(),
          partial=int((s.alive & (s.m < 0.999 * m0)).sum()),
          dead=int((~s.alive).sum()),
          alpha_max=float(s.alpha.max()), tree_plans_and_replans=counts)
    if max(errs.values()) > PARITY_TOL or not same or counts[0] != counts[1]:
        raise RuntimeError(f"block_sink_parity: kernel path disagrees with "
                           f"the plain path: {errs} {counts} {same}")
    sims = []
    k21 = 0
    for device in (dev, torch.device("cpu")):
        p = bb_params(SINK_PARITY_BB_N, rho_sink=BB_RHO_SINK)
        for k, v in {"particle_distribution": "random",
                     "rand_algorithm": "default",
                     "time_dependent_avisc": "cd2010",
                     "smooth_accretion": 1}.items():
            p.set(k, v)
        sim = GradhSphSimulation(p, device=device, dtype=torch.float64)
        sim.SetupSimulation()
        if device == dev:
            _ext.reset_launches()
        for _ in range(BB_CD_PARITY_STEPS):
            sim.main_loop_step()
        if device == dev:
            torch.cuda.synchronize()
            k21 = _ext.LAUNCHES["cullen_dehnen"]
        sims.append(sim)
    errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot", "alpha",
                                "m"))
    for f in ("r", "v", "m", "angmom"):
        x = getattr(sims[0].state.sinks, f).cpu()
        ref = getattr(sims[1].state.sinks, f)
        errs[f"sink_{f}"] = float(torch.abs(x - ref).max()
                                  / ref.abs().max().clamp_min(1e-300))
    same = bool(torch.equal(sims[0].state.alive.cpu(), sims[1].state.alive))
    counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
    s = sims[1].state
    phase("block_sink_parity", run="bb_cd2010_smooth", N=s.N,
          steps=BB_CD_PARITY_STEPS, rel_err=errs, same_alive=same,
          sinks=int(s.sinks.active.sum()), dead=int((~s.alive).sum()),
          alpha_range=[float(s.alpha[s.alive].min()),
                       float(s.alpha[s.alive].max())],
          k21_launches=k21, tree_plans_and_replans=counts,
          seconds=time.perf_counter() - t0)
    if max(errs.values()) > PARITY_TOL or not same \
            or counts[0] != counts[1] or k21 < BB_CD_PARITY_STEPS:
        raise RuntimeError(f"block_sink_parity: kernel path disagrees with "
                           f"the plain path: {errs} {counts} {same} {k21}")
    return {"cullen_dehnen": k21}


def bb_block_collapse(dev, card):
    """Phase 37, the slice at full width: bb_block_params at about
    262,144 particles in float32, setup, warm-up ticks, the timed ticks
    (the counts set to 0 just before them), the checks, then K20 and
    K22 against their plain versions at the path's state.  Returns their
    launches and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bb_block_params, bound,
                                         compare_td_sink_kernels,
                                         ledger_errors, sim_smooth_inputs,
                                         sink_ledger, smooth_args,
                                         total_mass)
    from gandalf_tpu_torch.ops.sinks import smooth_accretion_sums
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    sim = GradhSphSimulation(bb_block_params(BB_N, rho_sink=BB_RHO_SINK),
                             device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    m_start = sim.state.m.clone()
    mass0 = total_mass(sim)
    sinks0 = int(sim.state.sinks.active.sum())
    for _ in range(BB_BLOCK_TICKS_WARM):
        sim.main_loop_step()
    rows = sink_ledger(sim)
    replans0 = sim._n_grid_overflows
    t_sim0 = sim.t
    # every alive particle takes the dense tick's pass: summed on the
    # device, read after the window
    alive_updates = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(BB_BLOCK_TICKS_TIMED):
        sim.main_loop_step()
        alive_updates += sim.state.alive.sum()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    alive_updates = int(alive_updates)
    launches = {k: _ext.LAUNCHES[k] for k in BB_BLOCK + ("accretion_sums",)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    st, alive = s.sinks, s.alive
    act = st.active
    n_alive = int(alive.sum())
    mass1 = total_mass(sim)
    em, ep, m_given = ledger_errors(rows)
    ticks_run = len(rows)
    del rows
    partial = int((alive & (s.m < m_start)).sum())
    alpha = s.alpha[alive].double()
    levels = torch.bincount(s.level[alive].cpu()).tolist()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[alive]).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "gpot",
                                "alpha", "m"))
        and all(bool(torch.isfinite(getattr(st, f)[act]).all())
                for f in ("r", "v", "a", "m", "angmom")),
        "rho_positive": bool((s.rho[alive] > 0).all()),
        "sinks_formed": int(act.sum()) > sinks0,
        "mass_conserved": abs(mass1 - mass0) / mass0 <= BB_MASS_TOL,
        "ledger": len(em) >= BB_BLOCK_TICKS_TIMED
        and max(em + ep) <= BB_LEDGER_TOL,
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(launches[k] >= BB_BLOCK_TICKS_TIMED
                        for k in BB_BLOCK),
        "alpha_in_range": float(alpha.min()) >= 0.0
        and float(alpha.max()) <= sim.visc.alpha_visc,
    }
    # the orbit rule of smooth accretion: a claimed particle goes whole
    # where dt (dt_base here) < smooth_accrete_dt t_orbit of its sink
    inputs = sim_smooth_inputs(sim)
    _, sums = smooth_accretion_sums(*smooth_args(sim.kern, inputs))
    trot = 2.0 * math.pi * torch.sqrt(
        (sim.sink_cfg.sink_radius * st.h) ** 3
        / torch.clamp_min(sums["menc"] + st.m, 1e-30))
    orbit = {"dt_base": float(inputs["dt"]),
             "smooth_accrete_dt_times_least_t_orbit": float(
                 sim.params.floatparams["smooth_accrete_dt"]
                 * trot[act].min()) if bool(act.any()) else None}
    rep = compare_td_sink_kernels(sim.kern, smooth_inputs=inputs,
                                  sim=sim, state=s, repeats=5)
    names = ("smooth_accretion", "levelneib")
    for k in names:
        rep[k]["bound_ms"], rep[k]["bound_by"] = bound(rep[k]["work"],
                                                       torch.float32)
    phase("bb_block_collapse", N=s.N, ticks=sim.Nsteps,
          timed_ticks=BB_BLOCK_TICKS_TIMED, ticks_run=ticks_run,
          setup_s=t_setup, timed_s=elapsed,
          ticks_per_s=BB_BLOCK_TICKS_TIMED / elapsed,
          alive_particle_updates_per_s=alive_updates / elapsed,
          sim_time_per_wall_s=(sim.t - t_sim0) / elapsed,
          t_code=sim.t, dt_base_code=float(sim._blocksched.dt_base),
          level_max=int(sim._blocksched.level_max), levels=levels,
          sinks_active=int(act.sum()), sinks_formed=int(act.sum()) - sinks0,
          sink_masses=st.m[act].tolist(), alive=n_alive,
          dead=int((~alive).sum()), partial=partial, orbit_rule=orbit,
          mass_rel_change=abs(mass1 - mass0) / mass0,
          ledger_mass_err=max(em), ledger_momentum_err=max(ep),
          ledger_mass_err_per_call=em, ledger_momentum_err_per_call=ep,
          mass_given_per_call=m_given,
          alpha_range=[float(alpha.min()), float(alpha.max())],
          alpha_median=float(alpha.median()),
          launches=launches,
          launches_per_tick={k: v / BB_BLOCK_TICKS_TIMED
                             for k, v in launches.items()},
          replans_in_window=sim._n_grid_overflows - replans0,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"bb_block_collapse checks failed: {failed}")
    return {k: launches[k] for k in names}, {k: rep[k] for k in names}


def khi_cd2010(dev, card, variant=None, steps=KHI_CD_STEPS_TIMED,
               tag="khi_cd2010"):
    """Phase 38: khi_main_path's KHI with cd2010 in float32, 2 warm-up
    and 32 timed steps (the counts set to 0 just before them): the rate
    beside khi_main_path's, K21 (2D) once a step, median alpha below
    0.15, finiteness, energy drift and momentum; then K21 against its
    plain version at the path's state.  With the smoothing kernel
    `variant` (phase 111) K2, K3 and K21 launch under its names and no
    M4 name.  Returns its launches and report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_td_sink_kernels,
                                         family_params, kernel_name,
                                         khi_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = khi_params(KHI_SCALE)
    if variant is not None:
        params = family_params(variant, params)
    params.set("time_dependent_avisc", "cd2010")
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    sim.SetupSimulation()
    run_timed(sim, KHI_CD_STEPS_WARM)
    e0 = energy(sim.state)
    p0, _ = momentum(sim.state)
    replans0 = sim._n_grid_overflows
    _ext.reset_launches()
    elapsed = run_timed(sim, steps)
    spec, kern = sim.gridspec, sim.kern
    k21 = kernel_name("cullen_dehnen", spec, kern)
    names = ["grid27_bin_2d"] + [kernel_name(k, spec, kern)
                                 for k in HYDRO[1:]] + [k21]
    launches = {k: _ext.LAUNCHES[k] for k in names}
    m4_names = [kernel_name(k, spec) for k in HYDRO[1:]]
    m4_launches = {k: _ext.LAUNCHES[k] for k in m4_names
                   + ["cullen_dehnen_2d"] if k not in launches}
    s = sim.state
    N = s.N
    drift = abs(energy(s) - e0) / abs(e0)
    p1, mv = momentum(s)
    alpha = s.alpha.double()
    replans = sim._n_grid_overflows - replans0
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "alpha")),
        "no_overflow": not bool(s.neib_overflow),
        # a burst redone after an overflow replan launches again
        "k21_once_a_step": launches[k21] == steps if replans == 0
        else launches[k21] > steps,
        "launches": all(n >= steps for n in launches.values()),
        "no_m4_launch": not any(m4_launches.values()),
        "alpha_median": float(alpha.median()) < TD_ALPHA_MEDIAN,
        "energy_drift": drift < ENERGY_DRIFT_TOL,
    }
    rep = compare_td_sink_kernels(sim=sim, state=s, repeats=5)
    rate = N * steps / elapsed
    RATES[tag] = rate
    phase(tag, kernel=kern.variant, N=N, steps=sim.Nsteps,
          timed_steps=steps, timed_s=elapsed, particle_steps_per_s=rate,
          khi_main_path_particle_steps_per_s=RATES.get("khi_main_path"),
          khi_cd2010_particle_steps_per_s=RATES.get("khi_cd2010"),
          ncells=list(spec.ncells), k_cell=spec.k_cell,
          replans_in_window=replans, launches=launches,
          alpha_median=float(alpha.median()),
          alpha_range=[float(alpha.min()), float(alpha.max())],
          energy_drift=drift,
          momentum_change_over_sum_m_abs_v=float(
              np.abs(p1 - p0).max()) / mv,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    return {k21: launches[k21]}, {k21: rep[k21]}


def sod_td_avisc(dev, card):
    """Phase 39: the Sod tube (256 + 64, float64 on the card) to t = 0.25
    with mm97, then cd2010 (the counts set to 0 just before its run),
    each held to tests/test_adsod.py:111-179's gates; K21 (1D) against
    its plain version at the cd2010 run's end.  Returns its launches and
    report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_td_sink_kernels, sod_l1,
                                         sod_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    n1, n2, tend = TD_SOD
    out, launches, rep = {}, None, None
    for scheme in ("mm97", "cd2010"):
        params = sod_params(n1, n2, tend=tend)
        params.set("time_dependent_avisc", scheme)
        sim = GradhSphSimulation(params, device=dev, dtype=torch.float64)
        sim.SetupSimulation()
        alpha0 = sim.state.alpha.clone()
        if scheme == "cd2010":
            _ext.reset_launches()
        t0 = time.perf_counter()
        sim.Run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        alpha = sim.state.alpha.double()
        l1 = sod_l1(sim)
        res = {"N": sim.state.N, "steps": sim.Nsteps, "t": sim.t,
               "run_s": elapsed, "L1_vx": l1,
               "alpha_start": [float(alpha0.min()), float(alpha0.max())],
               "alpha_max": float(alpha.max()),
               "alpha_median": float(alpha.median())}
        res["ok"] = (bool(torch.all(alpha0 == 0.1))
                     and res["alpha_max"] > TD_ALPHA_MAX[scheme]
                     and res["alpha_median"] < TD_ALPHA_MEDIAN
                     and l1 < TD_SOD_L1 and abs(sim.t - tend) < 1e-12)
        if scheme == "cd2010":
            launches = {"cullen_dehnen_1d": _ext.LAUNCHES["cullen_dehnen_1d"]}
            res["ok"] = res["ok"] and launches["cullen_dehnen_1d"] >= \
                sim.Nsteps
            rep = compare_td_sink_kernels(sim=sim, state=sim.state,
                                          repeats=20)
        out[scheme] = res
    checks = {k: v["ok"] for k, v in out.items()}
    phase("sod_td_avisc", runs=out, launches=launches,
          gates={"alpha_max": TD_ALPHA_MAX, "alpha_median": TD_ALPHA_MEDIAN,
                 "L1_vx": TD_SOD_L1},
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"sod_td_avisc checks failed: {failed}")
    return launches, rep


# ---------------------------------------------------------------------------
# 40-43. the gas-dust drag (K23, K24)
# ---------------------------------------------------------------------------

def dust_kernels(dev):
    """Phase 40: K23 and K24 against their plain versions on the card on
    check.dust_kernel_inputs (per-row dt with tau on both sides of 1e-3,
    a coincident gas-dust pair, 5% dead): at 4,096 and at 32,768
    particles, in float64 and float32, in 1, 2 and 3 dims every law,
    two-fluid and test-particle, the energy term on and off, and both
    mirror layouts of tests/test_grid_mirror.py in 3D and the 1D mirror
    column.  One line per size and dtype with the largest scaled error
    of each kernel; a case's whole report where it fails.  K23 and K24
    are timed at 32,768 in 3D in float32 beside their bounds."""
    from gandalf_tpu_torch.check import (MIRROR_DIM0, MIRROR_MIXED, bound,
                                         compare_dust_kernels,
                                         dust_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.dust import DragLaw

    t0 = time.perf_counter()
    cases = []
    for nd in (1, 2, 3):
        for law, coeff in DUST_LAWS:
            for tp in (False, True):
                for energy_term in (True, False):
                    cases.append((nd, None, law, coeff, tp, energy_term))
    for nd, walls in ((3, MIRROR_DIM0), (3, MIRROR_MIXED), (1, MIRROR_DIM0)):
        for tp in (False, True):
            cases.append((nd, walls, "epstein", 1.5, tp, True))
    timed = None
    n_checked = 0
    for n in DUST_KERNEL_SIZES:
        for dtype in (torch.float64, torch.float32):
            inputs = {}
            worst = {}
            for nd, walls, law, coeff, tp, energy_term in cases:
                key = (nd, walls)
                if key not in inputs:
                    inputs[key] = dust_kernel_inputs(n, nd, dev, dtype,
                                                     walls=walls)
                s, box, spec, dt = inputs[key]
                timing = (n == DUST_KERNEL_SIZES[-1] and nd == 3
                          and walls is None and law == "epstein"
                          and not tp and energy_term
                          and dtype == torch.float32)
                rep = compare_dust_kernels(
                    kernel_factory("m4", nd),
                    DragLaw(law, coeff, energy_term), tp, s, box, spec, dt,
                    repeats=5 if timing else 0)
                n_checked += 1
                for k, r in rep.items():
                    worst[k] = max(worst.get(k, 0.0),
                                   max(r["scaled_err"].values()))
                if timing:
                    for r in rep.values():
                        r["bound_ms"], r["bound_by"] = bound(r["work"],
                                                             dtype)
                    timed = rep
                if timing or not all(r["ok"] for r in rep.values()):
                    phase("dust_kernels", N=n, ndim=nd,
                          walls=[list(w) for w in walls] if walls else None,
                          law=law, test_particle=tp,
                          energy_term=energy_term, dtype=str(dtype),
                          report=rep)
                require_ok("dust_kernels", rep)
            phase("dust_kernels", N=n, dtype=str(dtype), cases=len(cases),
                  max_scaled_err=worst)
            del inputs
    phase("dust_kernels_done", cases=n_checked,
          seconds=time.perf_counter() - t0)
    return timed


def _sim_pair(make, steps, tick_check=None):
    """Two simulations from `make(device)` -> (simulation, IC or None),
    on the card and on the CPU in float64, stepped together `steps`
    times; `tick_check(a, b)` is called after every step.  Returns the
    pair."""
    sims = []
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        sim, ic = make(device)
        sim.SetupSimulation(ic)
        sims.append(sim)
    for _ in range(steps):
        for sim in sims:
            sim.main_loop_step()
        if tick_check is not None:
            tick_check(*(x.state for x in sims))
    torch.cuda.synchronize()
    return sims


def dust_parity(dev) -> None:
    """Phase 41: float64, kernels on the card against the plain path on
    the CPU, with equal grid and tree plans: DUST_PARITY_BOX_STEPS steps
    of the 1D dusty box periodic and between mirror walls,
    DUST_PARITY_STEPS steps of the 1,824-particle dusty Evrard (Nhydro
    1000) with tree gravity, two-fluid and then test-particle, and
    DUST_PARITY_TICKS ticks of the same cloud with Nlevels 3 with equal
    levels on every tick."""
    from gandalf_tpu_torch.check import dust_params, dustybox_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    f64 = torch.float64
    runs = (
        ("dustybox_1d", DUST_PARITY_BOX_STEPS, dustybox_params(32, 1)),
        ("dustybox_1d_mirror", DUST_PARITY_BOX_STEPS,
         dustybox_params(32, 1, mirror_dim=0)),
        ("evrard_twofluid", DUST_PARITY_STEPS,
         dust_params(DUST_PARITY_EVRARD)),
        ("evrard_test_particle", DUST_PARITY_STEPS,
         dust_params(DUST_PARITY_EVRARD, "test_particle")),
        ("evrard_block", DUST_PARITY_TICKS,
         dust_params(DUST_PARITY_EVRARD, nlevels=3)),
    )
    for name, steps, params in runs:
        same = [True]

        def levels(a, b):
            same[0] &= bool(torch.equal(a.level.cpu(), b.level))

        sims = _sim_pair(
            lambda d: (GradhSphSimulation(params.copy(), d, f64), None),
            steps, levels if name == "evrard_block" else None)
        fields = ("r", "v", "u", "h", "rho")
        if sims[1].self_gravity:
            fields += ("gpot",)
        errs = parity_errors(sims, fields)
        counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
        specs_equal = sims[0].gridspec == sims[1].gridspec
        phase("dust_parity", run=name, N=sims[1].state.N, steps=steps,
              rel_err=errs, tree_plans_and_replans=counts,
              same_grid_plan=specs_equal,
              same_levels_each_tick=same[0] if name == "evrard_block"
              else None, k_cell=sims[1].gridspec.k_cell)
        if max(errs.values()) > PARITY_TOL or counts[0] != counts[1] \
                or not specs_equal or not same[0]:
            raise RuntimeError(f"dust_parity {name}: kernel path disagrees "
                               f"with the plain path: {errs} {counts}")
    phase("dust_parity_done", seconds=time.perf_counter() - t0)


def _box_means(sim):
    """Mean v_x of the gas and of the dust, the momentum and the kinetic
    plus thermal energy, in float64."""
    from gandalf_tpu_torch.state import GAS_TYPE

    s = sim.state
    gas = s.ptype == GAS_TYPE
    vx = s.v[:, 0].double()
    m = s.m.double()
    e = (0.5 * m * (s.v.double() ** 2).sum(-1) + m * s.u.double()).sum()
    return (float(vx[gas].mean()), float(vx[~gas].mean()),
            float((m * vx).sum()), float(e))


def dustybox_path(dev, card):
    """Phase 42: the dusty box on the grid path.  The 1D box of
    tests/test_dust.py:20-40 in float64: two-fluid to t = 1 held to
    :58-66's gates, test particles to t = 0.8 held to :135-143's; the
    walled run (mirror walls across y) on the 2D box at 32^2 to t = 0.3
    with :58-66's gates.  Then the 3D box at 64^3 gas + 64^3 dust in
    float32: 2 warm-up and 16 timed steps, the rate, dv(t)/dv0 against
    e^-t, the momentum change and K23 and K24 launched once a step, and
    both kernels against their plain versions at the box's state."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bound, compare_dust_kernels,
                                         dust_kernel_dt, dustybox_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    out, checks = {}, {}
    for name, params in (
            ("1d_twofluid", dustybox_params(32, 1, tend=1.0)),
            ("1d_test_particle", dustybox_params(
                32, 1, tend=0.8, dust_forces="test_particle")),
            ("2d_walls_y", dustybox_params(32, 2, mirror_dim=1, tend=0.3))):
        t0 = time.perf_counter()
        sim = GradhSphSimulation(params, device=dev, dtype=torch.float64)
        sim.Run()
        vg, vd, mom, e = _box_means(sim)
        dv = math.exp(-sim.t)
        if name == "1d_test_particle":
            errs = {"gas": abs(vg), "dust": abs(vd - dv)}
            ok = errs["gas"] < DUSTYBOX_TP_GAS \
                and errs["dust"] < DUSTYBOX_TP_DUST
        else:
            errs = {"gas": abs(vg - (0.5 - 0.5 * dv)),
                    "dust": abs(vd - (0.5 + 0.5 * dv)),
                    "momentum": abs(mom - 1.0), "energy": abs(e - 2.0) / 2.0}
            ok = (errs["gas"] < DUSTYBOX_GATE and errs["dust"] < DUSTYBOX_GATE
                  and errs["momentum"] < 1e-12 and errs["energy"] < 1e-5)
        out[name] = {"N": sim.state.N, "t": sim.t, "steps": sim.Nsteps,
                     "errors": errs, "seconds": time.perf_counter() - t0}
        checks[name] = ok
    sim = GradhSphSimulation(dustybox_params(DUSTYBOX_N3, 3), device=dev,
                             dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, DUSTYBOX_STEPS_WARM)
    vg0, vd0, mom0, _ = _box_means(sim)
    t_start = sim.t
    _ext.reset_launches()
    elapsed = run_timed(sim, DUSTYBOX_STEPS_TIMED)
    launches = {k: _ext.LAUNCHES[k] for k in HYDRO + ("dust_drag_sums",
                                                      "dust_drag_deposit")}
    vg, vd, mom, _ = _box_means(sim)
    s = sim.state
    ratio = (vd - vg) / (vd0 - vg0)
    expect = math.exp(-(sim.t - t_start))
    checks.update({
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho")),
        "relaxation": abs(ratio - expect) < DUSTYBOX_GATE,
        "momentum": abs(mom - mom0) <= 1e-5 * abs(mom0),
        "launches": launches["dust_drag_sums"] >= DUSTYBOX_STEPS_TIMED
        and launches["dust_drag_deposit"] >= DUSTYBOX_STEPS_TIMED,
    })
    rep = compare_dust_kernels(sim.kern, sim.drag_law, False, s, sim.box,
                               sim.gridspec, dust_kernel_dt(sim), repeats=5)
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], torch.float32)
    N = s.N
    phase("dustybox_path", runs=out, N=N, k_cell=sim.gridspec.k_cell,
          setup_s=t_setup, timed_steps=DUSTYBOX_STEPS_TIMED,
          timed_s=elapsed,
          particle_steps_per_s=N * DUSTYBOX_STEPS_TIMED / elapsed,
          dv_ratio=ratio, exp_minus_t=expect, momentum=[mom0, mom],
          launches=launches, checks=checks, kernels=rep, card=card,
          gates={"twofluid": DUSTYBOX_GATE, "tp_gas": DUSTYBOX_TP_GAS,
                 "tp_dust": DUSTYBOX_TP_DUST},
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"dustybox_path checks failed: {failed}")
    return rep


def dusty_evrard(dev, card, variant=None, steps=DUST_STEPS_TIMED,
                 tag="dusty_evrard"):
    """Phase 43, the slice at full width: check.dust_params at Nhydro
    131,072 (about 262,144 gas and dust particles) in float32, setup, 2
    warm-up steps, 32 timed steps (the counts set to 0 just before
    them), the checks and the tree's accuracy with the dust's masses,
    then K23 and K24 against their plain versions at the path's state.
    With the smoothing kernel `variant` (phase 112) K2, K3, K7, K23 and
    K24 launch under its names and no M4 name.  Returns K23's and K24's
    launches and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bound, compare_dust_kernels,
                                         dust_energy, dust_kernel_dt,
                                         dust_params, family_params,
                                         gravity_accuracy)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = dust_params(DUST_NHYDRO)
    if variant is not None:
        params = family_params(variant, params)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    s = sim.state
    dust = s.ptype == 3
    m_gas0 = float(s.m[~dust].double().sum())
    m_dust0 = float(s.m[dust].double().sum())
    run_timed(sim, DUST_STEPS_WARM)
    e0 = dust_energy(sim)
    replans0 = sim._n_grid_overflows
    t_sim0 = sim.t
    _ext.reset_launches()
    elapsed = run_timed(sim, steps)
    names = [_ext.family_count(k, sim.kern) if k in FAMILY_KERNELS else k
             for k in DUST]
    launches = {k: _ext.LAUNCHES[k] for k in names}
    m4_launches = {k: _ext.LAUNCHES[k] for k in DUST if k not in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    drift = abs(dust_energy(sim) - e0) / abs(e0)
    acc = gravity_accuracy(sim, n_sample=2048)
    N = s.N
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "gpot")),
        "rho_positive_gas": bool((s.rho[~dust] > 0).all()),
        "rho_positive_dust": bool((s.rho[dust] > 0).all()),
        "gas_mass_exact": float(s.m[~dust].double().sum()) == m_gas0,
        "dust_mass_exact": float(s.m[dust].double().sum()) == m_dust0,
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= steps for n in launches.values()),
        "no_m4_launch": not any(m4_launches.values()),
        "energy_drift": drift <= DUST_ENERGY_DRIFT_TOL,
    }
    rep = compare_dust_kernels(sim.kern, sim.drag_law, False, s, sim.box,
                               sim.gridspec, dust_kernel_dt(sim), repeats=1)
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], torch.float32)
    spec = sim.treespec
    RATES[tag] = N * steps / elapsed
    phase(tag, kernel=sim.kern.variant, N=N, n_dust=int(dust.sum()),
          steps=sim.Nsteps, timed_steps=steps, setup_s=t_setup,
          timed_s=elapsed, particle_steps_per_s=N * steps / elapsed,
          dusty_evrard_particle_steps_per_s=RATES.get("dusty_evrard"),
          sim_time=[t_sim0, sim.t], k_cell=sim.gridspec.k_cell,
          ncells=list(sim.gridspec.ncells),
          grid_replans_in_window=sim._n_grid_overflows - replans0,
          G_pad=spec.n_leaves, near_cap=spec.near_cap,
          launches=launches, energy_drift=drift,
          energy_gate=DUST_ENERGY_DRIFT_TOL, accuracy=acc,
          accuracy_gate=ACCURACY_TOL, checks=checks, kernels=rep,
          card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    checks["accuracy"] = acc["rms_rel_err"] <= ACCURACY_TOL
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    names = [_ext.family_count(k, sim.kern)
             for k in ("dust_drag_sums", "dust_drag_deposit")]
    return {k: launches[k] for k in names}, {k: rep[k] for k in names}


def sm2012_kernels(dev) -> None:
    """Phase 44: K25 and K26 against their plain versions on the card on
    check.sm2012_kernel_inputs (a jittered lattice with a u jump, 5%
    dead, a coincident pair in 2 and 3 dims, a full cell, h off its
    converged value) at two sizes in 1, 2 and 3 dims, in float64 and
    float32, with mon97 viscosity per pair and alpha per particle
    (mon97mm97).  One line per case; K25 and K26 are timed at the larger
    3D size in float32 beside their bounds."""
    from gandalf_tpu_torch.check import (bound, compare_sm2012_kernels,
                                         sm2012_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.forces import (AVISC_MON97, AVISC_MON97MM97,
                                              ArtificialViscosity)

    t0 = time.perf_counter()
    n_cases = 0
    for nd, sides in SM_KERNEL_SIDES.items():
        for side in sides:
            for dtype in (torch.float64, torch.float32):
                s, spec = sm2012_kernel_inputs(side, nd, dev, dtype)
                for avisc in (AVISC_MON97, AVISC_MON97MM97):
                    timing = (nd == 3 and side == sides[-1]
                              and dtype == torch.float32
                              and avisc == AVISC_MON97)
                    rep = compare_sm2012_kernels(
                        kernel_factory("m4", nd),
                        ArtificialViscosity(avisc=avisc), 1.4, 1.2, 0.01,
                        spec, s, repeats=5 if timing else 0)
                    if timing:
                        for r in rep.values():
                            r["bound_ms"], r["bound_by"] = bound(r["work"],
                                                                 dtype)
                    n_cases += 1
                    phase("sm2012_kernels", ndim=nd, N=s.N,
                          dtype=str(dtype), avisc=avisc, report=rep)
                    require_ok("sm2012_kernels", rep)
    phase("sm2012_kernels_done", cases=n_cases,
          seconds=time.perf_counter() - t0)


def _sm2012_report(sim, state, repeats):
    """K25 and K26 against their plain versions at a simulation's state,
    each with its bound in the state's dtype."""
    from gandalf_tpu_torch.check import bound, compare_sm2012_kernels

    rep = compare_sm2012_kernels(sim.kern, sim.visc, sim.gamma, sim.h_fac,
                                 sim.h_converge, sim.gridspec, state,
                                 repeats=repeats)
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], state.r.dtype)
    return rep


def khi_sm2012(dev, card, variant=None, steps=KHI_STEPS_TIMED,
               tag="khi_sm2012"):
    """Phase 45, the slice at full width: khi_main_path's KHI
    (check.khi_params(KHI_SCALE), 425,984 particles, float32) through
    SM2012SphSimulation: setup, 2 warm-up steps, 32 timed steps with the
    counts set to 0 just before them, khi_main_path's gates, and K25 and
    K26 (2D) against their plain versions at the path's state.  With the
    smoothing kernel `variant` (phase 111) K25 and K26 launch under its
    names and no M4 name.  Returns the launches and the kernel
    reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (family_params, kernel_name,
                                         khi_params, sm2012_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    params = khi_params(KHI_SCALE)
    if variant is not None:
        params = family_params(variant, params)
    sim = SimulationBase.factory(sm2012_params(params), dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, KHI_STEPS_WARM)
    e0 = energy(sim.state)
    p0, _ = momentum(sim.state)
    replans0 = sim._n_grid_overflows
    _ext.reset_launches()
    elapsed = run_timed(sim, steps)
    names = [kernel_name(k, sim.gridspec, sim.kern) for k in SM2012]
    launches = {k: _ext.LAUNCHES[k] for k in ["grid27_bin_2d"] + names}
    # neither grad-h kernel, nor K25 and K26 under another kernel's name
    grad_h = {n: _ext.LAUNCHES[n] for n in (
        kernel_name(k, sim.gridspec, kern) for k in HYDRO[1:]
        for kern in (None, sim.kern))}
    grad_h.update({k: _ext.LAUNCHES[k] for k in (
        kernel_name(k, sim.gridspec) for k in SM2012) if k not in names})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    drift = abs(energy(s) - e0) / abs(e0)
    p1, mv = momentum(s)
    dp = float(np.abs(p1 - p0).max()) / mv
    rho = s.rho.double()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= steps for n in launches.values()),
        "no_grad_h_kernels": not any(grad_h.values()),
        "energy_drift": drift < ENERGY_DRIFT_TOL,
        "contrast": float(rho.min()) < 1.3 and float(rho.max()) > 1.6,
    }
    rep = _sm2012_report(sim, s, 5)
    rate = N * steps / elapsed
    RATES[tag] = rate
    phase(tag, kernel=sim.kern.variant, N=N,
          ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, steps=sim.Nsteps,
          timed_steps=steps, setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=rate,
          khi_main_path_particle_steps_per_s=RATES.get("khi_main_path"),
          khi_sm2012_particle_steps_per_s=RATES.get("khi_sm2012"),
          t_code=sim.t, dt_code=float(s.dt),
          replans_in_window=sim._n_grid_overflows - replans0,
          launches=launches, grad_h_launches=grad_h, energy_drift=drift,
          momentum_change_over_sum_m_abs_v=dp, rho_min=float(rho.min()),
          rho_max=float(rho.max()), checks=checks, kernels=rep, card=card,
          peak_mem_gb=peak_gb, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    return {k: launches[k] for k in names}, rep


def sm2012_gravity_box(dev, card):
    """Phase 46: the self-gravitating box of gravity_main_path
    (make_sim(64, ..., self_gravity=1), 262,144 particles, float32)
    through SM2012SphSimulation: setup, 2 warm-up steps, the post-warm-up
    replan, 2 more, then 32 timed steps (the counts set to 0 just before
    them), with the energy drift, the tree's accuracy against the direct
    sum, the launches of K1, K25, K26 and K4-K7 each step, and K25 and
    K26 against their plain versions at the path's state.  Returns K25's
    and K26's launches and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (gravity_accuracy, jittered_box_ic,
                                         slice_params, sm2012_params)
    from gandalf_tpu_torch.sim.simulation import SM2012SphSimulation

    t_phase = time.perf_counter()
    params = sm2012_params(slice_params(N_MAIN, self_gravity=1))
    sim = SM2012SphSimulation(params, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(jittered_box_ic(params, N_MAIN))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, STEPS_WARM)
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    e0 = energy(sim.state, gravity=True)
    replans0 = sim._n_grid_overflows
    _ext.reset_launches()
    elapsed = run_timed(sim, GRAVITY_STEPS_TIMED)
    names = ("grid27_bin",) + SM2012 + GRAVITY[3:]
    launches = {k: _ext.LAUNCHES[k] for k in names}
    grad_h = {k: _ext.LAUNCHES[k] for k in HYDRO[1:]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    acc = gravity_accuracy(sim, n_sample=2048)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= GRAVITY_STEPS_TIMED
                        for n in launches.values()),
        "no_grad_h_kernels": not any(grad_h.values()),
        "zeta_zero": float(torch.abs(s.zeta).max()) == 0.0,
        "accuracy": acc["rms_rel_err"] <= ACCURACY_TOL,
        "energy_drift": drift <= GRAVITY_ENERGY_DRIFT_TOL,
    }
    rep = _sm2012_report(sim, s, 5)
    phase("sm2012_gravity_box", N=N, steps=sim.Nsteps,
          timed_steps=GRAVITY_STEPS_TIMED, setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * GRAVITY_STEPS_TIMED / elapsed,
          replans_in_window=sim._n_grid_overflows - replans0,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, grad_h_launches=grad_h, energy_drift=drift,
          accuracy=acc, accuracy_gate=ACCURACY_TOL, checks=checks,
          kernels=rep, card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"sm2012_gravity_box checks failed: {failed}")
    return {k: launches[k] for k in SM2012}, rep


def sm2012_tube(dev, card):
    """Phase 47: tests/test_sm2012.py's 1D gates in float64 on the card,
    on the grid path: the Sod tube (256 + 64, t = 0.25, the counts set to
    0 just before its run) with L1(vx) over -1 < x < 1 below 0.03 and
    the energy within 1e-4 of its initial value (:45-64); the static
    contact discontinuity (32 + 128, t = 0.5) through SM2012 and through
    grad-h SPH, SM2012's largest |v| below 0.05 and below 0.8 times
    grad-h's (:67-97).  Then K25 and K26 (1D) against their plain
    versions at the Sod run's end.  Returns the Sod run's launches and
    the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (contact_params, kernel_name,
                                         sm2012_params, sod_l1, sod_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    n1, n2, tend = SM_SOD
    sim = SimulationBase.factory(sm2012_params(sod_params(n1, n2, tend)),
                                 dev, torch.float64)
    sim.SetupSimulation()
    _ext.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.Run()
    torch.cuda.synchronize()
    sod_s = time.perf_counter() - t0
    launches = {kernel_name(k, sim.gridspec):
                _ext.LAUNCHES[kernel_name(k, sim.gridspec)] for k in SM2012}
    l1 = sod_l1(sim)
    e0 = 2.0 * (1.0 + 0.1975) / 0.4
    e_err = abs(energy(sim.state) - e0) / e0
    rep = _sm2012_report(sim, sim.state, 20)
    sod = {"N": sim.state.N, "steps": sim.Nsteps, "t": sim.t,
           "run_s": sod_s, "L1_vx": l1, "energy_rel_err": e_err}
    vmax = {}
    for name in ("sm2012sph", "gradhsph"):
        c = SimulationBase.factory(contact_params(name), dev, torch.float64)
        c.Run()
        vmax[name] = float(torch.abs(c.state.v[:, 0]).max())
    checks = {
        "sod_l1": l1 < SM_SOD_L1_GATE and abs(sim.t - tend) < 1e-12,
        "sod_energy": e_err <= SM_SOD_ENERGY_TOL,
        "launches": all(n >= sim.Nsteps for n in launches.values()),
        "contact_quiet": vmax["sm2012sph"] < SM_CONTACT_VMAX,
        "contact_sharper_than_gradh":
            vmax["sm2012sph"] < SM_CONTACT_RATIO * vmax["gradhsph"],
    }
    phase("sm2012_tube", sod=sod, contact_vmax=vmax, launches=launches,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"sm2012_tube checks failed: {failed}")
    return launches, rep


def sm2012_parity(dev) -> None:
    """Phase 48: float64, kernels on the card against the plain path on
    the CPU, with equal grid and tree plans: 5 steps of the
    self-gravitating box at 16^3 (the tree rebuilt every 2 steps) and 5
    steps of the hybrid Plummer sphere with 256 gas particles and 8
    accreting stars, both through SM2012SphSimulation, the sinks' masses
    and the alive gas equal."""
    from gandalf_tpu_torch.check import (jittered_box_ic,
                                         plummer_stars_params, slice_params,
                                         sm2012_params)
    from gandalf_tpu_torch.sim.simulation import SM2012SphSimulation

    t0 = time.perf_counter()
    f64 = torch.float64

    def box(d):
        p = sm2012_params(slice_params(16, self_gravity=1))
        p.set("ntreebuildstep", GRAVITY_NTB_PARITY)
        return SM2012SphSimulation(p, d, f64), jittered_box_ic(p, 16)

    def stars(d):
        return (SM2012SphSimulation(sm2012_params(plummer_stars_params()),
                                    d, f64), None)

    for name, make in (("gravity_box", box), ("sinks", stars)):
        sims = _sim_pair(make, PARITY_STEPS)
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot"))
        same = sims[0].gridspec == sims[1].gridspec and torch.equal(
            sims[0].state.alive.cpu(), sims[1].state.alive)
        if sims[1].has_sinks:
            ref = sims[1].state.sinks.m
            errs["sink_m"] = float(torch.abs(sims[0].state.sinks.m.cpu()
                                             - ref).max() / ref.max())
        counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
        phase("sm2012_parity", run=name, N=sims[1].state.N,
              steps=PARITY_STEPS, rel_err=errs,
              tree_plans_and_replans=counts, same_plans_and_alive=same)
        if max(errs.values()) > PARITY_TOL or counts[0] != counts[1] \
                or not same:
            raise RuntimeError(f"sm2012_parity {name}: kernel path "
                               f"disagrees with the plain path: {errs}")
    phase("sm2012_parity_done", seconds=time.perf_counter() - t0)


def extpot_box(dev, card) -> None:
    """Phase 49: external potentials in the hydro controllers on the card
    (float64): the vertical-potential box of tests/test_extpot.py:18-42
    on the grid path (a 6^3 lattice; every particle's a_z is avert to
    1e-10, its other components 0), and 8 steps of the hybrid Plummer
    sphere with stars in a Plummer field, held against the plain path on
    the CPU (PARITY_TOL, the sinks' masses included)."""
    from gandalf_tpu_torch.check import (extpot_box_params,
                                         plummer_stars_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    sim = GradhSphSimulation(extpot_box_params("vertical", EXTPOT_AVERT),
                             dev, torch.float64)
    sim.SetupSimulation()
    a = sim.state.a
    err_z = float(torch.abs(a[:, 2] - EXTPOT_AVERT).max())
    err_xy = float(torch.abs(a[:, :2]).max())
    sims = _sim_pair(lambda d: (GradhSphSimulation(
        plummer_stars_params(extpot="plummer"), d, torch.float64), None),
        EXTPOT_STEPS)
    errs = parity_errors(sims, ("r", "v", "a", "u", "h", "rho", "gpot"))
    ref = sims[1].state.sinks.m
    errs["sink_m"] = float(torch.abs(sims[0].state.sinks.m.cpu() - ref).max()
                           / ref.max())
    checks = {"vertical_az": err_z <= EXTPOT_TOL and err_xy <= EXTPOT_TOL,
              "plummer_parity": max(errs.values()) <= PARITY_TOL}
    phase("extpot_box", N=sim.state.N, az_err=err_z, axy_max=err_xy,
          plummer_steps=EXTPOT_STEPS, plummer_rel_err=errs, checks=checks,
          card=card, seconds=time.perf_counter() - t0)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"extpot_box checks failed: {failed}")


# ---------------------------------------------------------------------------
# RadWS and radiative feedback (phases 50-55)
# ---------------------------------------------------------------------------

def radws_kernels(dev) -> None:
    """Phase 50: K27-K29 against their plain versions on the card on
    check.radws_kernel_inputs at 262,144 elements (both edge clamps hit),
    on the synthetic ideal table and on check.nonideal_table (kappa,
    kappa_p, mu and gamma varying, one energy row not monotone), in
    float64 and float32: K27 flat and on a dense (4,096, 64) shape with
    every fifth slot empty, K28 with the scalar and the per-element
    T_amb, K29 with a scalar dt and per-element dt and T_amb; then K30 on
    check.ambient_kernel_inputs at 262,144 particles with 16 and with
    4,096 slots (every mass class, an eighth inactive, a particle on an
    active slot), disc heating off, with one and two central slots, and
    sink_heating off.  Flips and errors per case; timed in float32 beside
    the bounds (the ideal table; K30 at both slot counts)."""
    from gandalf_tpu_torch.check import (ambient_kernel_inputs, bound,
                                         compare_ambient_kernels,
                                         compare_radws_kernels,
                                         radws_kernel_inputs)

    t0 = time.perf_counter()
    n_cases = 0
    for dtype in (torch.float64, torch.float32):
        for table in ("ideal", "nonideal"):
            timing = dtype == torch.float32 and table == "ideal"
            inp = radws_kernel_inputs(RADWS_N, dev, dtype, table)
            rep = compare_radws_kernels(inp, repeats=5 if timing else 0,
                                        dense_shape=RADWS_DENSE)
            if timing:
                for r in rep.values():
                    r["bound_ms"], r["bound_by"] = bound(r["work"], dtype)
            n_cases += len(rep)
            phase("radws_kernels", table=table, dtype=str(dtype),
                  report=rep)
            require_ok("radws_kernels", rep)
        for ns in RADWS_SLOTS:
            inp = ambient_kernel_inputs(RADWS_N, ns, dev, dtype)
            timing = dtype == torch.float32
            rep = compare_ambient_kernels(inp, repeats=5 if timing else 0)
            if timing:
                for r in rep.values():
                    r["bound_ms"], r["bound_by"] = bound(r["work"], dtype)
            n_cases += len(rep)
            phase("radws_kernels", kernel="K30", Ns=ns, dtype=str(dtype),
                  report=rep)
            require_ok("radws_kernels", rep)
    phase("radws_kernels_done", cases=n_cases,
          seconds=time.perf_counter() - t0)


def _radws_report(sim, dense=False, repeats=5):
    """K27-K29 against their plain versions at a simulation's state (its
    table and alive particles; with `dense` K27 first on the grid pass's
    own dense slots, then flat as the block tick calls it), each with its
    bound in the state's dtype."""
    from gandalf_tpu_torch.check import (bound, compare_radws_kernels,
                                         radws_dense_inputs,
                                         radws_sim_inputs)

    rep = compare_radws_kernels(
        radws_sim_inputs(sim), repeats=repeats,
        dense=radws_dense_inputs(sim) if dense else None)
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], sim.dtype)
    return rep


def _temperature_gate(sim):
    """T = u (gamma-1) mu_bar of the alive particles against
    temp_ambient: (min T, max T, all within RADWS_T_TOL of it)."""
    s, fp = sim.state, sim.params.floatparams
    T = (s.u[s.alive] * (fp["gamma_eos"] - 1.0) * fp["mu_bar"]).double()
    t_amb = fp["temp_ambient"]
    ok = bool((torch.abs(T / t_amb - 1.0) <= RADWS_T_TOL).all())
    return float(T.min()), float(T.max()), ok


def _radws_box_sim(dev, nlevels=1):
    from gandalf_tpu_torch.check import (jittered_box_ic, radws_params,
                                         slice_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    params = radws_params(slice_params(N_MAIN, self_gravity=1))
    if nlevels > 1:
        params.set("Nlevels", nlevels)
        params.set("level_diff_max", 1)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    return sim, jittered_box_ic(params, N_MAIN)


def radws_box(dev, card):
    """Phase 51, the radws path at full width: gravity_main_path's box
    (check.slice_params(64, self_gravity=1), 262,144 particles, float32,
    the quadrupole tree) on check.radws_params (gas_eos =
    energy_integration = radws, gamma 5/3, mu 1, press1 66.67,
    temp_ambient 10: tests/test_radws.py's hot box, T0 = 66.7): setup, 2
    warm-up and 32 timed steps (the counts set to 0 just before them),
    finiteness, rho > 0, no unresolved overflow, K1-K7, K27 and K28
    every step, the tree's accuracy, and T = u (gamma-1) mu within 10%
    of temp_ambient at the end (tests/test_radws.py:96-104); then K27-K29
    against their plain versions at the path's state, K27 on the grid
    pass's dense slots (the kernel line's case) and flat.  Returns K27's
    and K28's launches and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import gravity_accuracy

    t_phase = time.perf_counter()
    sim, ic = _radws_box_sim(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    fp = sim.params.floatparams
    T0 = float(sim.state.u.max()) * (fp["gamma_eos"] - 1.0) * fp["mu_bar"]
    run_timed(sim, STEPS_WARM)
    replans0 = sim._n_grid_overflows
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, GRAVITY_STEPS_TIMED)
    done = sim.Nsteps - steps0
    launches = {k: _ext.LAUNCHES[k] for k in GRAVITY + RADWS_SPH}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    acc = gravity_accuracy(sim, n_sample=2048)
    t_min, t_max, t_ok = _temperature_gate(sim)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot", "ueq", "pressure", "sound")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= done for n in launches.values()),
        "accuracy": acc["rms_rel_err"] <= ACCURACY_TOL,
        "cooled_to_ambient": t_ok,
    }
    rep = _radws_report(sim, dense=True)
    phase("radws_box", N=N, steps=sim.Nsteps, timed_steps=done,
          setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * done / elapsed,
          gravity_main_path_particle_steps_per_s=RATES.get("gravity"),
          t_code=sim.t, dt_code=float(s.dt), T_start_max=T0,
          T_min=t_min, T_max=t_max, T_gate=RADWS_T_TOL,
          replans_in_window=sim._n_grid_overflows - replans0,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, accuracy=acc, accuracy_gate=ACCURACY_TOL,
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"radws_box checks failed: {failed}")
    return ({k: launches[k] for k in RADWS_SPH},
            {k: rep[k] for k in RADWS_SPH})


def radws_block_box(dev, card):
    """Phase 52: radws_box's configuration with Nlevels 3 (level_diff_max
    1; tests/test_radws.py:106-130): setup, 2 warm-up and 32 timed
    ticks of the compacted tick (K1, K8, K9, the group-list K6/K7, K27,
    K28 every tick), the same checks and the T gate at the end."""
    from gandalf_tpu_torch import _ext

    t_phase = time.perf_counter()
    sim, ic = _radws_box_sim(dev, nlevels=3)
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, RADWS_BLOCK_WARM)
    rows0, steps0 = sim.active_rows, sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, RADWS_BLOCK_TICKS)
    ticks = sim.Nsteps - steps0
    names = BLOCK + RADWS_SPH
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    t_min, t_max, t_ok = _temperature_gate(sim)
    levels = torch.bincount(s.level.long()).tolist()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "ueq",
                                "pressure", "sound")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= ticks for n in launches.values()),
        "cooled_to_ambient": t_ok,
    }
    phase("radws_block_box", N=s.N, ticks=ticks, setup_s=t_setup,
          timed_s=elapsed, ticks_per_s=ticks / elapsed,
          active_updates_per_s=(sim.active_rows - rows0) / elapsed,
          levels=levels, t_code=sim.t, T_min=t_min, T_max=t_max,
          T_gate=RADWS_T_TOL, launches=launches, checks=checks, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"radws_block_box checks failed: {failed}")


def radfb_cluster(dev, card):
    """Phase 53: check.plummer_stars_params(RADFB_N, 4) on radws with
    radiative feedback (check.radfb_params: rad_fb = sink_heating =
    ambient_heating = disc_heating = 1, temp_ambient 1, source radii
    0.01); mplummer 2 and starfrac 0.5 give each star about 0.25, a
    stellar-class source, and slot 0 is the central one.  Setup (the
    host IC's seconds), 2 warm-up and RADFB_STEPS_TIMED timed steps
    (K1-K7, K14, K16, K18, K27, K28 and K30 every step; no K17: the stars
    come from the IC, create_sinks = 0), gas plus star mass within
    BB_MASS_TOL, finiteness
    over the alive gas, and T_amb >= temp_ambient for every particle at
    the end; then K30 against its plain version at the path's state (the
    run's own case, 4 slots).  Returns K30's launches and report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bound, compare_ambient_kernels,
                                         plummer_stars_params, radfb_params,
                                         total_mass)
    from gandalf_tpu_torch.ops.radiative_fb import \
        combined_ambient_temperature
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    sim = GradhSphSimulation(radfb_params(plummer_stars_params(RADFB_N, 4)),
                             device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    ic_s = sim.timing.totals.get("GENERATE_IC", 0.0)
    run_timed(sim, STEPS_WARM)
    m0 = total_mass(sim)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, RADFB_STEPS_TIMED)
    done = sim.Nsteps - steps0
    names = GRAVITY + ("direct_softened", "star_gas_forces",
                       "accretion_sums") + RADWS_SPH + ("ambient_temperature",)
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s, sk = sim.state, sim.state.sinks
    alive = s.alive
    m1 = total_mass(sim)
    act = sk.active if sim.radfb_sink_on else torch.zeros_like(sk.active)
    t_amb = combined_ambient_temperature(
        sim.radfb_sink_cfg, sim.radfb_disc_cfg, s.r, sk.r, sk.m, sk.mdot,
        sk.h * sim.sink_cfg.sink_radius, act)
    _ext.reset_launches()
    _ext.LAUNCHES.update(launches)
    t_inf = sim.params.floatparams["temp_ambient"]
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[alive]).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "ueq",
                                "dt_therm")),
        "mass": abs(m1 - m0) / m0 <= BB_MASS_TOL,
        "t_amb_at_least_ambient": bool((t_amb >= t_inf).all()),
        "launches": all(n >= done for n in launches.values()),
    }
    inputs = {"r": s.r, "rs": sk.r, "m": sk.m, "mdot": sk.mdot,
              "rad": sk.h * sim.sink_cfg.sink_radius, "active": sk.active,
              "cfg": sim.radfb_sink_cfg}
    rep = compare_ambient_kernels(inputs, repeats=5, cases=(
        ("path", int(sim.radfb_sink_on), sim.radfb_disc_cfg),))
    rep = {"ambient_temperature": rep["ambient_temperature_path"]}
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], torch.float32)
    phase("radfb_cluster", N=s.N, n_star=sk.N, alive=int(alive.sum()),
          steps=sim.Nsteps, timed_steps=done, setup_s=t_setup, ic_s=ic_s,
          timed_s=elapsed, particle_steps_per_s=s.N * done / elapsed,
          star_m=sk.m.tolist(), star_mdot=sk.mdot.tolist(),
          t_amb_min=float(t_amb.min()), t_amb_max=float(t_amb.max()),
          t_amb_median=float(t_amb.median()), mass_rel_change=
          abs(m1 - m0) / m0, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, launches=launches, checks=checks,
          kernels=rep,
          card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"radfb_cluster checks failed: {failed}")
    return ({"ambient_temperature": launches["ambient_temperature"]}, rep)


def radws_mfv_box(dev, card):
    """Phase 54: mfv_box (check.mfv_params(64), 262,144 particles,
    float32, the quadrupole tree) on check.radws_params: setup, 2
    warm-up steps, the post-warm-up replan, 2 more, then 32 timed steps
    (K1, K4-K7 in the MFV mode, K10-K12, K27 and K29 every step), the
    mass exact, finiteness, and T within 12% of temp_ambient at the end
    (tests/test_radws.py:320-335); then K27-K29 against their plain
    versions at the path's state.  Returns K29's launches and report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import jittered_box_ic, mfv_params, \
        radws_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    params = radws_params(mfv_params(N_MAIN))
    sim = SimulationBase.factory(params, dev, torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation(jittered_box_ic(params, N_MAIN))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    m0 = sim.state.m.clone()
    run_timed(sim, STEPS_WARM)
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, MFV_STEPS_TIMED)
    done = sim.Nsteps - steps0
    names = MFV + ("radws_eos", "radws_implicit_heating")
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    T = (s.u * (params.floatparams["gamma_eos"] - 1.0)).double()
    t_amb = params.floatparams["temp_ambient"]
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "Qcons0",
                                "pressure", "sound", "gpot")),
        "mass_exact": bool(torch.equal(s.m, m0)),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= (2 * done if k == "grid27_bin" else done)
                        for k, n in launches.items()),
        "cooled_to_ambient": bool((torch.abs(T / t_amb - 1.0)
                                   <= RADWS_MFV_T_TOL).all()),
    }
    rep = _radws_report(sim)
    phase("radws_mfv_box", N=s.N, steps=sim.Nsteps, timed_steps=done,
          setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=s.N * done / elapsed,
          mfv_main_path_particle_steps_per_s=RATES.get("mfv"),
          T_min=float(T.min()), T_max=float(T.max()),
          T_gate=RADWS_MFV_T_TOL, launches=launches, checks=checks,
          kernels=rep, card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"radws_mfv_box checks failed: {failed}")
    return ({"radws_implicit_heating": launches["radws_implicit_heating"]},
            {"radws_implicit_heating": rep["radws_implicit_heating"]})


def radws_parity(dev) -> None:
    """Phase 55: float64, kernels on the card against the plain path on
    the CPU through _sim_pair (equal grid and tree plans, alive gas and
    sinks): 5 steps of the radws box at 8^3 with self-gravity (the tree
    rebuilt every 2 steps), 5 ticks of it with Nlevels 3 (equal levels
    each tick), 5 steps of the hybrid Plummer sphere (256 gas, 4 stars)
    with radiative feedback, and 5 steps of the radws MFV box at 8^3;
    every field within PARITY_TOL, ueq and dt_therm included."""
    from gandalf_tpu_torch.check import (jittered_box_ic, mfv_params,
                                         plummer_stars_params, radfb_params,
                                         radws_params, slice_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    f64 = torch.float64

    def box(nlevels):
        def make(d):
            p = radws_params(slice_params(RADWS_PARITY_N, self_gravity=1))
            p.set("ntreebuildstep", GRAVITY_NTB_PARITY)
            if nlevels > 1:
                p.set("Nlevels", nlevels)
                p.set("level_diff_max", 1)
            return (SimulationBase.factory(p, d, f64),
                    jittered_box_ic(p, RADWS_PARITY_N))
        return make

    def cluster(d):
        return SimulationBase.factory(radfb_params(plummer_stars_params(
            256, 4)), d, f64), None

    def mfv(d):
        p = radws_params(mfv_params(RADWS_PARITY_N))
        p.set("ntreebuildstep", GRAVITY_NTB_PARITY)
        return SimulationBase.factory(p, d, f64), jittered_box_ic(
            p, RADWS_PARITY_N)

    def same_levels(a, b):
        if not torch.equal(a.level.cpu(), b.level):
            raise RuntimeError("radws_parity: levels differ")

    runs = (("box", box(1), None, ("ueq", "dt_therm")),
            ("block_box", box(3), same_levels, ("ueq", "dt_therm")),
            ("cluster_radfb", cluster, None, ("ueq", "dt_therm")),
            ("mfv_box", mfv, None, ()))
    for name, make, check, extra in runs:
        sims = _sim_pair(make, PARITY_STEPS, check)
        fields = ("r", "v", "u", "h", "rho", "gpot") + extra
        errs = parity_errors(sims, fields)
        if getattr(sims[1], "has_sinks", False):
            ref = sims[1].state.sinks.m
            errs["sink_m"] = float(torch.abs(sims[0].state.sinks.m.cpu()
                                             - ref).max() / ref.max())
        same = sims[0].gridspec == sims[1].gridspec
        phase("radws_parity", run=name, N=sims[1].state.N,
              steps=PARITY_STEPS, rel_err=errs, same_grid_plan=same)
        if max(errs.values()) > PARITY_TOL or not same:
            raise RuntimeError(f"radws_parity {name}: kernel path disagrees "
                               f"with the plain path: {errs}")
    phase("radws_parity_done", seconds=time.perf_counter() - t0)


# -- the quintic, gaussian and tabulated kernels (phases 56-62) ---------------

def kernel_family_kernels(dev) -> None:
    """Phase 56: K2 and K3 (1-3 dims), K7 (3D, not the gaussian) and K8,
    K9 (3D) with each smoothing-kernel variant against their plain
    versions on the card (check.compare_family_kernels), in float64 and
    float32, with the tabulated kernels' pairs near a table point."""
    from gandalf_tpu_torch.check import compare_family_kernels

    t0 = time.perf_counter()
    n_cases = 0
    for variant in FAMILY_VARIANTS:
        for ndim in (1, 2, 3):
            for dtype in (torch.float64, torch.float32):
                t1 = time.perf_counter()
                rep = compare_family_kernels(variant, ndim, dev, dtype)
                torch.cuda.synchronize()
                phase("kernel_family_kernels", variant=variant, ndim=ndim,
                      dtype=str(dtype), report=rep,
                      seconds=time.perf_counter() - t1)
                require_ok("kernel_family_kernels", rep)
                n_cases += 1
    phase("kernel_family_kernels_done", cases=n_cases,
          seconds=time.perf_counter() - t0)


def family_parity(dev) -> None:
    """Phase 57: float64 on the card against the plain path on the CPU,
    with equal grid and tree plans: FAMILY_PARITY_STEPS steps of the 8^3
    box with each variant (tree gravity but with the gaussian), and
    FAMILY_BLOCK_TICKS ticks of the block sphere (BLOCK_PARITY_N) with
    the quintic."""
    from gandalf_tpu_torch.check import (family_params, jittered_box_ic,
                                         slice_params, sphere_block_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    fields = ("r", "v", "u", "h", "rho")
    for variant in FAMILY_VARIANTS + ("quintic_block",):
        block = variant == "quintic_block"
        grav = 0 if variant.startswith("gaussian") else 1
        sims = []
        for device in (dev, torch.device("cpu")):
            if block:
                p = family_params("quintic",
                                  sphere_block_params(BLOCK_PARITY_N))
                ic = None
            else:
                p = family_params(variant, slice_params(
                    FAMILY_PARITY_N, self_gravity=grav))
                ic = jittered_box_ic(p, FAMILY_PARITY_N)
            sim = GradhSphSimulation(p, device=device, dtype=torch.float64)
            sim.SetupSimulation(ic)
            for _ in range(FAMILY_BLOCK_TICKS if block
                           else FAMILY_PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        errs = parity_errors(sims, fields + (("gpot",) if grav else ()))
        same = {"grid": sims[0].gridspec == sims[1].gridspec,
                "tree": sims[0].treespec == sims[1].treespec,
                "plans": ((sims[0]._n_tree_plans, sims[0]._n_grid_overflows)
                          == (sims[1]._n_tree_plans,
                              sims[1]._n_grid_overflows))}
        if block:
            same["levels"] = bool(torch.equal(sims[0].state.level.cpu(),
                                              sims[1].state.level))
        phase("family_parity", run=variant, N=sims[1].state.N,
              steps=sims[1].Nsteps, kernel=sims[1].kern.variant,
              rel_err=errs, same=same)
        if max(errs.values()) > PARITY_TOL or not all(same.values()):
            raise RuntimeError(f"family_parity {variant}: kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same}")
    phase("family_parity_done", seconds=time.perf_counter() - t0)


def _family_box(dev, card, tag, variant, grav, steps):
    """gravity_main_path's box (or, without `grav`, main_path's) at 64^3
    in float32 with the smoothing kernel `variant`: setup, warm-up (with
    gravity, the post-warm-up replan and more warm-up), `steps` timed
    steps (the counts set to 0 just before them), the checks, and K2, K3
    (and K7) against their plain versions at the path's state; prints
    the phase line `tag` and raises if a check failed.  Returns the
    launches and the kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_kernels,
                                         compare_tree_kernels,
                                         family_params, gravity_accuracy,
                                         jittered_box_ic, slice_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    p = family_params(variant, slice_params(N_MAIN, self_gravity=grav))
    sim = GradhSphSimulation(p, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(jittered_box_ic(p, N_MAIN))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, STEPS_WARM)
    if grav:
        sim._plan_tree_buckets(sim.state.r.cpu().numpy())
        run_timed(sim, STEPS_WARM)
    e0 = energy(sim.state, gravity=bool(grav))
    replans0, steps0 = sim._n_grid_overflows, sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, steps)
    done = sim.Nsteps - steps0
    kern = sim.kern
    names = ([_ext.family_count(k, kern)
              for k in ("grid27_density", "grid27_forces")]
             + ([_ext.family_count("tree_near", kern)] if grav else []))
    launches = {k: _ext.LAUNCHES[k] for k in names}
    for k in ("grid27_density", "grid27_forces", "tree_near"):
        # no M4 kernel runs on this path
        launches[f"{k} (M4)"] = _ext.LAUNCHES[k]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    drift = abs(energy(s, gravity=bool(grav)) - e0) / abs(e0)
    flds = ("r", "v", "a", "u", "h", "rho", "dudt") + (
        ("gpot",) if grav else ())
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in flds),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(launches[k] >= done for k in names),
        "no_m4_launch": all(launches[f"{k} (M4)"] == 0 for k in
                            ("grid27_density", "grid27_forces",
                             "tree_near")),
        "energy_drift": drift <= (GRAVITY_ENERGY_DRIFT_TOL if grav
                                  else ENERGY_DRIFT_TOL),
    }
    out = dict(variant=variant, N=N, steps=sim.Nsteps, timed_steps=done,
               setup_s=t_setup, timed_s=elapsed,
               particle_steps_per_s=N * done / elapsed,
               replans_in_window=sim._n_grid_overflows - replans0,
               ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
               launches=launches, energy_drift=drift,
               peak_mem_gb=peak_gb)
    if grav:
        acc = gravity_accuracy(sim, n_sample=2048)
        checks["accuracy"] = acc["rms_rel_err"] <= ACCURACY_TOL
        checks["no_overflow"] = checks["no_overflow"] and not acc["overflow"]
        out.update(accuracy=acc, accuracy_gate=ACCURACY_TOL,
                   near_cap=sim.treespec.near_cap,
                   support_cap=sim.treespec.support_cap)
    rep = compare_kernels(sim, s, repeats=5)
    if grav:
        rep.update(compare_tree_kernels(sim, s, repeats=5))
    rep = {k: r for k, r in rep.items() if k in names}
    phase(tag, **out, checks=checks, kernels=rep, card=card,
          gravity_main_path_particle_steps_per_s=RATES.get("gravity"),
          main_path_particle_steps_per_s=RATES.get("hydro"),
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} ({variant}) checks failed: {failed}")
    return {k: launches[k] for k in names}, rep


def quintic_gravity_box(dev, card):
    """Phase 58: gravity_main_path's self-gravitating box
    (bench.build_sim(64), 262,144 particles, float32) with the quintic:
    32 timed steps, K1-K7 (K2, K3, K7 quintic) every step and no M4
    K2, K3 or K7, the energy drift (<= 1e-2) and the tree's accuracy at
    2,048 particles against the float64 all-pairs sum with the quintic
    softening (<= 2e-4), the rate beside gravity_main_path's; then K2,
    K3 and K7 against their plain versions at the path's state."""
    return _family_box(dev, card, "quintic_gravity_box", "quintic", 1,
                       GRAVITY_STEPS_TIMED)


def tabulated_gravity_box(dev, card):
    """Phase 59: the same box with the reference's default, the M4
    kernel tabulated (tabulated_kernel = 1): 32 timed steps, the same
    gates; then the tabulated quintic for TAB_QUINTIC_STEPS steps, the
    same gates.  K2, K3 and K7 of both against their plain versions."""
    launches, rep = {}, {}
    for variant, steps in (("m4_tab", GRAVITY_STEPS_TIMED),
                           ("quintic_tab", TAB_QUINTIC_STEPS)):
        lch, r = _family_box(dev, card, "tabulated_gravity_box", variant, 1,
                             steps)
        launches.update(lch)
        rep.update(r)
    return launches, rep


def gaussian_box(dev, card):
    """Phase 60: main_path's hydro-only box (64^3, float32) with the
    gaussian: 16 timed steps, K1-K3 (K2, K3 gaussian) every step, the
    energy drift below 1e-3; then K2 and K3 against their plain
    versions at the path's state."""
    return _family_box(dev, card, "gaussian_box", "gaussian", 0,
                       STEPS_TIMED)


def gaussian_soundwave(dev, card):
    """Phase 61: the SPH sound wave of tests/test_soundwave.py:14-32
    (check.soundwave_params: 1D, 64 particles, isothermal, the gaussian,
    one period to t = 2) on the port's grid path in float64, the counts
    set to 0 just before Run(): L1(rho) below 1e-4 (test_soundwave_sph's
    gate, check.soundwave_l1), K2 and K3 (1D, gaussian) every step; then
    both against their plain versions at the end."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_kernels, soundwave_l1,
                                         soundwave_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    sim = SimulationBase.factory(soundwave_params(), dev, torch.float64)
    sim.SetupSimulation()
    _ext.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.Run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    names = [_ext.family_count(k, sim.kern) + "_1d"
             for k in ("grid27_density", "grid27_forces")]
    launches = {k: _ext.LAUNCHES[k] for k in names}
    l1 = soundwave_l1(sim)
    rep = {k: r for k, r in compare_kernels(sim, sim.state,
                                            repeats=20).items()
           if k in names}
    for r in rep.values():
        r["dtype"] = str(torch.float64)
    checks = {"l1_rho": l1 < SOUNDWAVE_L1_GATE,
              "at_tend": abs(sim.t - 2.0) < 1e-12,
              "launches": all(n >= sim.Nsteps for n in launches.values())}
    phase("gaussian_soundwave", N=sim.state.N, steps=sim.Nsteps, t=sim.t,
          run_s=elapsed, L1_rho=l1, l1_gate=SOUNDWAVE_L1_GATE,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"gaussian_soundwave checks failed: {failed}")
    return launches, rep


def quintic_block(dev, card):
    """Phase 62: block_main_path's cold sphere (BLOCK_N, the same IC)
    with the quintic: QUINTIC_BLOCK_WARM warm-up and QUINTIC_BLOCK_TICKS
    timed ticks (the counts set to 0 just before them) through K1, K8,
    K9 and the group-list K6/K7 (quintic), with no M4 K8, K9 or K7, the
    block gates (finiteness, overflow, the tree's accuracy among the
    active) and the energy drift held to QUINTIC_BLOCK_ENERGY_DRIFT_TOL
    (fault F24); then K8, K9 and the list K6/K7 against their plain
    versions at the path's state."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_active_kernels,
                                         family_params, gravity_accuracy,
                                         sphere_block_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    p = family_params("quintic", sphere_block_params(BLOCK_N))
    sim = GradhSphSimulation(p, device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation(block_ic(p))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    N = sim.state.N
    for _ in range(QUINTIC_BLOCK_WARM):
        sim.main_loop_step()
    e0 = full_gravity_energy(sim)
    rows0 = sim.active_rows
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(QUINTIC_BLOCK_TICKS):
        sim.main_loop_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    names = [_ext.family_count(k, sim.kern) for k in
             ("active_density", "active_forces", "tree_near_list")]
    launches = {k: _ext.LAUNCHES[k] for k in names + ["tree_walk_list"]}
    m4 = {k: _ext.LAUNCHES[k] for k in
          ("active_density", "active_forces", "tree_near_list")}
    s = sim.state
    drift = abs(full_gravity_energy(sim) - e0) / abs(e0)
    active = torch.nonzero(s.nlast == sim._blocksched.n).flatten().to(
        torch.int32)
    acc = gravity_accuracy(sim, n_sample=2048, among=active)
    levels = torch.bincount(s.level.cpu()).tolist()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(launches[k] >= QUINTIC_BLOCK_TICKS
                        for k in names[:2]),
        "no_m4_launch": not any(m4.values()),
        "accuracy": acc["rms_rel_err"] <= BLOCK_ACCURACY_TOL,
        "energy_drift": drift <= QUINTIC_BLOCK_ENERGY_DRIFT_TOL,
    }
    rep = {k: r for k, r in compare_active_kernels(sim, s, active,
                                                   repeats=5).items()
           if k in names}
    phase("quintic_block", N=N, ticks=sim.Nsteps,
          timed_ticks=QUINTIC_BLOCK_TICKS, setup_s=t_setup,
          timed_s=elapsed, ticks_per_s=QUINTIC_BLOCK_TICKS / elapsed,
          active_rows_per_s=(sim.active_rows - rows0) / elapsed,
          levels=levels, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, launches=launches, m4_launches=m4,
          energy_drift=drift,
          energy_drift_gate=QUINTIC_BLOCK_ENERGY_DRIFT_TOL, accuracy=acc,
          accuracy_gate=BLOCK_ACCURACY_TOL, checks=checks, kernels=rep,
          card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"quintic_block checks failed: {failed}")
    return {k: launches[k] for k in names}, rep


def _mfv_modes(gamma):
    """K12's modes for mfv_option_kernels: both Riemann solvers, the
    Gizmo clamp, the cell alphas (tvdscalar), alpha = 1 (null) and
    zeroslope, MUSCL and RK2, moving and static particles."""
    from gandalf_tpu_torch.ops.mfv import MfvConfig

    return [MfvConfig(gamma=gamma, riemann=rs, slope_limiter=lim,
                      time_scheme=ts, static_particles=st)
            for rs in ("hllc", "exact")
            for lim in ("gizmo", "tvdscalar", "null", "zeroslope")
            for ts in ("muscl", "rk2") for st in (False, True)]


def mfv_option_kernels(dev) -> None:
    """Phase 63: K10-K12 at ndim 1 and 2, K12 in 32 modes (_mfv_modes) and
    K31 (tvdscalar and springel2009) at ndim 1-3 against their plain
    versions on the card, in float64 and float32, after setup and 2
    steps of the MFV Sod tube (128 + 32), the 2D box of
    tests/test_mfv_grid.py (64^2 + 64^2) and mfv_box at 16^3 (hydro
    only, jittered)."""
    from gandalf_tpu_torch.check import (compare_mfv_kernels,
                                         jittered_box_ic, mfv_khi_params,
                                         mfv_params, mfv_sod_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    box = mfv_params(16, self_gravity=0)
    cases = (("tube", mfv_sod_params(128, 32), None),
             ("box2d", mfv_khi_params(64), None),
             ("box3d", box, jittered_box_ic(box, 16)))
    for tag, params, ic in cases:
        for dtype in (torch.float64, torch.float32):
            sim = SimulationBase.factory(params.copy(), dev, dtype)
            sim.SetupSimulation(None if ic is None else dict(ic))
            sim.main_loop_steps(2)
            rep = compare_mfv_kernels(
                sim, sim.state, flux_cfgs=_mfv_modes(sim.mfv_cfg.gamma),
                sweeps=["tvdscalar", "springel2009"])
            for r in rep.values():
                r.pop("work", None)
            phase("mfv_option_kernels", case=tag, ndim=sim.ndim,
                  N=sim.state.N, dtype=str(dtype),
                  k_cell=sim.gridspec.k_cell, report=rep)
            require_ok("mfv_option_kernels", rep)
    phase("mfv_option_kernels_done", seconds=time.perf_counter() - t0)


def mfv_dims_parity(dev) -> None:
    """Phase 64: the five-step runs of tests/test_torch_mfv_dims.py
    (check.MFV_PARITY_CASES: the tube in four option sets, the 2D box in
    two, the Gresho vortex, the isothermal sound wave) in float64,
    kernels on the card against the plain path on the CPU: r, v, u, rho,
    h and Wprim within PARITY_TOL, the same grid plans."""
    from gandalf_tpu_torch.check import MFV_PARITY_CASES, mfv_parity_case
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    worst = {}
    for name in MFV_PARITY_CASES:
        sims = []
        for device in (dev, torch.device("cpu")):
            params, ic = mfv_parity_case(name)
            sim = SimulationBase.factory(params, device, torch.float64)
            sim.SetupSimulation(ic)
            for _ in range(PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        errs = parity_errors(sims, ("r", "v", "u", "rho", "h", "Wprim"))
        same_plan = sims[0].gridspec == sims[1].gridspec
        worst[name] = max(errs.values())
        phase("mfv_dims_parity", case=name, N=sims[1].state.N,
              steps=PARITY_STEPS, rel_err=errs, same_grid_plan=same_plan)
        if worst[name] > PARITY_TOL or not same_plan:
            raise RuntimeError(f"mfv_dims_parity: {name} disagrees with "
                               f"the plain path: {errs}")
    phase("mfv_dims_parity_done", worst=worst,
          seconds=time.perf_counter() - t0)


def _first_counts(launches, rep, counts, report):
    """Add each kernel of `counts` (a run's counts) and its report the
    first time a phase's runs meet it: the kernel line takes it from
    the first run that launched it."""
    for k, n in counts.items():
        if k not in launches:
            launches[k] = n
            rep[k] = report[k]


def _mfv_run(params, dev, dtype, ic=None):
    """An MFV controller on the card after setup, its counts set to 0,
    then Run() to tend: (sim, seconds)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    sim = SimulationBase.factory(params, dev, dtype)
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    sim.Run()
    torch.cuda.synchronize()
    return sim, time.perf_counter() - t0


def _mfv_path_counts(sim, names):
    """The counts of `names`, each given in a ndim-free form, on the
    simulation's dims."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import kernel_name
    from gandalf_tpu_torch.ops.mfv_grid27 import flux_count

    keys = [kernel_name(k, sim.gridspec, sim.kern) for k in names]
    keys.append(flux_count(sim.gridspec, sim.mfv_cfg, kern=sim.kern))
    return {k: _ext.LAUNCHES[k] for k in keys}


def mfv_sod_tube(dev, card):
    """Phase 65: the MFV Sod tube (check.mfv_sod_params, 512 + 128) on the
    card in float64 to t = 0.5, the counts set to 0 before each Run():
    MUSCL with HLLC and the Gizmo limiter and mfvrk held to the
    reference's gate L1(vx) < 7e-3 (tests/test_mfv.py:62, :171-185), the
    exact solver with tvdscalar to its CPU plain run's L1 within 1e-9;
    then the seven limiter names at 128 + 32 to t = 0.1, finite with
    vx.max() > 0.3 (tests/test_mfv.py:144-168).  Each run's kernels every
    step, the mass exact; the kernels against their plain versions at
    the runs' ends."""
    from gandalf_tpu_torch.check import (MFV_EXACT_TUBE_L1,
                                         compare_mfv_kernels,
                                         mfv_sod_params, sod_l1)

    t_phase = time.perf_counter()
    launches, rep, l1s, checks = {}, {}, {}, {}
    for tag, over in (("muscl", {}), ("mfvrk", {"sim": "mfvrk"}),
                      ("exact_tvdscalar", {"riemann_solver": "exact",
                                           "slope_limiter": "tvdscalar"})):
        sim, run_s = _mfv_run(mfv_sod_params(**over), dev, torch.float64)
        sweep = ("mfv_limiter_tvdscalar",) if "tvd" in tag else ()
        counts = _mfv_path_counts(sim, ("mfv_density", "mfv_gradients")
                                  + sweep)
        l1 = sod_l1(sim)
        l1s[tag] = {"L1_vx": l1, "steps": sim.Nsteps, "run_s": run_s}
        checks[f"{tag}_at_tend"] = abs(
            sim.t - sim.params.floatparams["tend"]) < 1e-12
        checks[f"{tag}_launches"] = all(n >= sim.Nsteps
                                        for n in counts.values())
        checks[f"{tag}_finite"] = bool(torch.isfinite(sim.state.v).all())
        if tag == "exact_tvdscalar":
            checks["exact_l1_equals_cpu"] = abs(
                l1 - MFV_EXACT_TUBE_L1) <= 1e-9 * MFV_EXACT_TUBE_L1
        else:
            checks[f"{tag}_l1"] = l1 < MFV_SOD_L1_GATE
        r = compare_mfv_kernels(sim, sim.state, repeats=20)
        _first_counts(launches, rep, counts, r)
    limiters = {}
    for lim in MFV_LIMITER_NAMES:
        sim, run_s = _mfv_run(mfv_sod_params(128, 32, 0.1,
                                             slope_limiter=lim),
                              dev, torch.float64)
        vx = sim.state.v[:, 0]
        limiters[lim] = {"vx_max": float(vx.max()), "steps": sim.Nsteps}
        checks[f"{lim}_finite"] = bool(torch.isfinite(vx).all())
        checks[f"{lim}_vx_max"] = float(vx.max()) > MFV_LIMITER_VX
        if lim in ("zeroslope", "scalar", "springel2009"):
            sweep = (("mfv_limiter_springel2009",)
                     if lim == "springel2009" else ())
            counts = _mfv_path_counts(sim, sweep)
            checks[f"{lim}_launches"] = all(n >= sim.Nsteps
                                            for n in counts.values())
            r = compare_mfv_kernels(sim, sim.state, repeats=20)
            _first_counts(launches, rep, counts, r)
    phase("mfv_sod_tube", runs=l1s, l1_gate=MFV_SOD_L1_GATE,
          exact_l1_cpu=MFV_EXACT_TUBE_L1, limiter_names=limiters,
          launches=launches, checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"mfv_sod_tube checks failed: {failed}")
    return launches, rep


def mfv_soundwave(dev, card):
    """Phase 66: the MFV sound wave of tests/test_soundwave.py:50-53
    (check.mfv_soundwave_params: 64 particles, isothermal, M4, HLLC, one
    period to t = 2) on the grid path in float64: L1(rho) < 2e-3."""
    from gandalf_tpu_torch.check import mfv_soundwave_params, soundwave_l1

    t_phase = time.perf_counter()
    sim, run_s = _mfv_run(mfv_soundwave_params(), dev, torch.float64)
    counts = _mfv_path_counts(sim, ("mfv_density", "mfv_gradients"))
    l1 = soundwave_l1(sim)
    checks = {"l1_rho": l1 < MFV_SOUNDWAVE_GATE,
              "at_tend": abs(sim.t - sim.params.floatparams["tend"]) < 1e-12,
              "launches": all(n >= sim.Nsteps for n in counts.values())}
    phase("mfv_soundwave", N=sim.state.N, steps=sim.Nsteps, run_s=run_s,
          L1_rho=l1, l1_gate=MFV_SOUNDWAVE_GATE, launches=counts,
          checks=checks, card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"mfv_soundwave checks failed: {failed}")


def gresho_mfv(dev, card):
    """Phase 67: the Gresho vortex of tests/test_ic_2d.py:78-109 through
    MFV (check.gresho_params(32)) on the card in float64 to t = 0.3:
    L1(v_phi) < 0.12 (check.gresho_l1), the kernels every step."""
    from gandalf_tpu_torch.check import gresho_l1, gresho_params

    t_phase = time.perf_counter()
    sim, run_s = _mfv_run(gresho_params(GRESHO_N), dev, torch.float64)
    counts = _mfv_path_counts(sim, ("mfv_density", "mfv_gradients"))
    l1 = gresho_l1(sim)
    checks = {"l1_vphi": l1 < GRESHO_L1_GATE,
              "at_tend": abs(sim.t - sim.params.floatparams["tend"]) < 1e-12,
              "launches": all(n >= sim.Nsteps for n in counts.values())}
    phase("gresho_mfv", N=sim.state.N, steps=sim.Nsteps, run_s=run_s,
          L1_vphi=l1, l1_gate=GRESHO_L1_GATE, launches=counts,
          checks=checks, card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"gresho_mfv checks failed: {failed}")


def _mfv_energy_nd(s, gravity: bool = False) -> float:
    """sum Q_E of an MFV state in float64 (with `gravity`, less sum m
    gpot / 2)."""
    e = float(torch.sum(s.Qcons0[:, s.ndim + 1].double()))
    if gravity:
        e -= 0.5 * float(torch.sum((s.m * s.gpot).double()))
    return e


def mfv_khi(dev, card):
    """Phase 68: the 2D box of tests/test_mfv_grid.py:19-41 at x16 per
    axis (check.mfv_khi_params(512): 524,288 particles) in float32:
    setup, 2 warm-up steps, 32 timed steps with HLLC and the Gizmo
    limiter; then the same from a new setup with the exact solver and
    tvdscalar, 16 timed steps (_mfv_khi_run)."""
    launches, rep = {}, {}
    for steps, over in zip(MFV_KHI_STEPS, ({}, {
            "riemann_solver": "exact", "slope_limiter": "tvdscalar"})):
        counts, r = _mfv_khi_run(dev, card, steps, **over)
        _first_counts(launches, rep, counts, r)
    return launches, rep


def _mfv_khi_run(dev, card, steps, tag="mfv_khi", sweeps=(), **over):
    """One run of mfv_khi's box with `over` set: the rate, the counts
    (set to 0 before the timed steps), K1 twice and K10-K12 (and K31)
    every step, mass exact, energy drift within 2e-3, min rho < 1.3 and
    max rho > 1.6, finite fields; the kernels against their plain
    versions (K12 also under RK2; K31 also with the limiters `sweeps`,
    which the run does not sweep) and under both thread mappings at the
    run's end.  Prints the phase line `tag`; returns the counts and the
    kernel reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (bound, compare_mfv_kernels,
                                         mfv_khi_params, mfv_mapping_times)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    sim = SimulationBase.factory(mfv_khi_params(MFV_KHI_N, **over), dev,
                                 torch.float32)
    sim.SetupSimulation()
    m0 = sim.state.m.clone()
    run_timed(sim, STEPS_WARM)
    e0 = _mfv_energy_nd(sim.state)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, steps)
    done = sim.Nsteps - steps0
    lim = sim.mfv_cfg.slope_limiter
    sweep = (f"mfv_limiter_{lim}",) if lim in _ext.MFV_SWEEP else ()
    counts = _mfv_path_counts(sim, ("mfv_density", "mfv_gradients")
                              + sweep)
    bins = _ext.LAUNCHES["grid27_bin_2d"]
    s = sim.state
    drift = abs(_mfv_energy_nd(s) - e0) / abs(e0)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "u", "h", "rho", "Qcons0",
                                "grad")),
        "mass_exact": bool(torch.equal(s.m, m0)),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= done for n in counts.values())
        and bins >= 2 * done,
        "energy_drift": drift <= MFV_KHI_ENERGY_TOL,
        "rho_min": float(s.rho.min()) < 1.3,
        "rho_max": float(s.rho.max()) > 1.6,
    }
    # K12 also under RK2 at this state, for its time at the 2D box
    r = compare_mfv_kernels(sim, s, repeats=5, flux_cfgs=[
        sim.mfv_cfg, dataclasses.replace(sim.mfv_cfg, time_scheme="rk2")])
    if sweeps:
        for k, x in compare_mfv_kernels(sim, s, repeats=5, flux_cfgs=[],
                                        sweeps=list(sweeps)).items():
            if k.startswith("mfv_limiter"):
                x["bound_ms"], x["bound_by"] = bound(x["work"],
                                                     torch.float32)
                r[k] = x
    mapping = mfv_mapping_times(sim, s)
    mode = ("exact_" if sim.mfv_cfg.riemann == "exact" else "hllc_") + lim
    RATES[f"{tag}_{mode}"] = s.N * done / elapsed
    phase(tag, mode=mode, kernel=sim.kern.variant, N=s.N, steps=sim.Nsteps,
          timed_steps=done, timed_s=elapsed,
          particle_steps_per_s=s.N * done / elapsed,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=counts, energy_drift=drift,
          rho_range=[float(s.rho.min()), float(s.rho.max())],
          checks=checks, kernels=r, slot_mappings=mapping, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, x in r.items() if not x["ok"]]
    if failed:
        raise RuntimeError(f"{tag} ({mode}) checks failed: {failed}")
    return counts, r


def _mfv_box_variant(dev, card, tag, **over):
    """mfv_main_path's box (mfv_box, 64^3, the quadrupole tree) with
    `over` set: setup, 2 warm-up steps, the replan, 2 more, then 32
    timed steps, mfv_main_path's gates (finite, mass exact, overflow,
    launches, the tree's accuracy, energy drift), then the kernels
    against their plain versions at the path's state."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_mfv_kernels,
                                         jittered_box_ic, mfv_gravity_accuracy,
                                         mfv_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    params = mfv_params(N_MAIN)
    for k, v in over.items():
        params.set(k, v)
    sim = SimulationBase.factory(params, dev, torch.float32)
    sim.SetupSimulation(jittered_box_ic(params, N_MAIN))
    m0 = sim.state.m.clone()
    run_timed(sim, STEPS_WARM)
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    e0 = mfv_energy(sim.state)
    steps0 = sim.Nsteps
    _ext.reset_launches()
    elapsed = run_timed(sim, MFV_STEPS_TIMED)
    done = sim.Nsteps - steps0
    sweep = (("mfv_limiter_" + sim.mfv_cfg.slope_limiter,)
             if sim.mfv_cfg.slope_limiter in ("tvdscalar", "springel2009")
             else ())
    counts = _mfv_path_counts(sim, ("mfv_density", "mfv_gradients",
                                    "tree_near_mfv") + sweep)
    s = sim.state
    drift = abs(mfv_energy(s) - e0) / abs(e0)
    acc = mfv_gravity_accuracy(sim, n_sample=2048)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "Qcons0",
                                "grad", "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= done for n in counts.values()),
        "mass_exact": bool(torch.equal(s.m, m0)),
        "accuracy": acc["rms_rel_err"] <= ACCURACY_TOL,
        "energy_drift": drift <= MFV_ENERGY_DRIFT_TOL,
    }
    r = compare_mfv_kernels(sim, s, repeats=5)
    RATES[tag] = s.N * done / elapsed
    phase(tag, N=s.N, steps=sim.Nsteps, timed_steps=done, timed_s=elapsed,
          particle_steps_per_s=s.N * done / elapsed,
          mfv_main_path_particle_steps_per_s=RATES.get("mfv"),
          kernel=sim.kern.variant, k_cell=sim.gridspec.k_cell,
          launches=counts, energy_drift=drift,
          energy_gate=MFV_ENERGY_DRIFT_TOL, accuracy=acc, checks=checks,
          kernels=r, card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, x in r.items() if not x["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    # mfv_main_path's K10, K11 and K7 entries stand in the kernel line
    keep = [k for k in counts if k not in ("mfv_density", "mfv_gradients",
                                           "tree_near_mfv")]
    return {k: counts[k] for k in keep}, {k: r[k] for k in keep}


def mfvrk_box(dev, card):
    """Phase 69: mfv_box under mfvrk (MfvRungeKuttaSimulation): K12 in its
    RK2 mode every step, mfv_main_path's gates."""
    return _mfv_box_variant(dev, card, "mfvrk_box", sim="mfvrk")


def mfv_exact_box(dev, card):
    """Phase 70: mfv_box with the exact Riemann solver and springel2009:
    K11, K31 and K12 in its exact, cell-alpha mode every step,
    mfv_main_path's gates."""
    return _mfv_box_variant(dev, card, "mfv_exact_box",
                            riemann_solver="exact",
                            slope_limiter="springel2009")


def mfv_block_kernels(dev) -> None:
    """Phase 71: K12's block mode, K22 (1-3 dims), K32 and K33 against
    their plain versions on the card in float64 and float32
    (check.compare_mfv_block_kernels), after setup and 3 ticks under the
    conservative limiter of the block Sod tube (128 + 32), the 2D box of
    tests/test_mfv_grid.py (32^2 + 32^2, jittered) and mfv_box at 16^3
    with the tree (jittered), Nlevels 3."""
    from gandalf_tpu_torch.check import (compare_mfv_block_kernels,
                                         jittered_box_ic, jittered_lattice_ic,
                                         mfv_block_tube_params,
                                         mfv_khi_params, mfv_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    box = mfv_params(16, self_gravity=1)
    box.set("Nlevels", 3)
    khi = mfv_khi_params(32, Nlevels=3)
    cases = (("tube", mfv_block_tube_params(3, 128, 32), None),
             ("box2d", khi, jittered_lattice_ic(khi)),
             ("box3d", box, jittered_box_ic(box, 16)))
    for tag, params, ic in cases:
        params.set("time_step_limiter", "conservative")
        for dtype in (torch.float64, torch.float32):
            sim = SimulationBase.factory(params.copy(), dev, dtype)
            sim.SetupSimulation(None if ic is None else dict(ic))
            for _ in range(MFV_BLOCK_KERNEL_TICKS):
                sim.main_loop_step()
            rep = compare_mfv_block_kernels(sim)
            for r in rep.values():
                r.pop("work", None)
            phase("mfv_block_kernels", case=tag, ndim=sim.ndim,
                  N=sim.state.N, dtype=str(dtype),
                  k_cell=sim.gridspec.k_cell,
                  ncells=list(sim.gridspec.ncells), report=rep)
            require_ok("mfv_block_kernels", rep)
    phase("mfv_block_kernels_done", seconds=time.perf_counter() - t0)


def mfv_block_parity(dev) -> None:
    """Phase 72: the 2D box (32^2 + 32^2, jittered) with Nlevels 3 under
    each time_step_limiter, 5 float64 ticks, kernels on the card against
    the plain path on the CPU: the state within PARITY_TOL, levels,
    levelneib, nlast and the schedule's integers equal, dt_base within
    1e-12, the same grid plans."""
    from gandalf_tpu_torch.check import jittered_lattice_ic, mfv_khi_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    worst = {}
    for limiter in ("none", "simple", "conservative"):
        params = mfv_khi_params(32, Nlevels=3, time_step_limiter=limiter)
        ic = jittered_lattice_ic(params)
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = SimulationBase.factory(params.copy(), device,
                                         torch.float64)
            sim.SetupSimulation(dict(ic))
            for _ in range(PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        errs = parity_errors(sims, ("r", "v", "u", "m", "h", "rho", "Qcons0",
                                    "dQ", "dQdt"))
        same_ints = all(torch.equal(getattr(sims[0].state, f).cpu(),
                                    getattr(sims[1].state, f))
                        for f in ("level", "levelneib", "nlast"))
        same_ints &= all(torch.equal(getattr(sims[0]._blocksched, f).cpu(),
                                     getattr(sims[1]._blocksched, f))
                         for f in ("n", "level_max", "nresync", "nstep_part"))
        dtb = [float(x._blocksched.dt_base) for x in sims]
        dtb_err = abs(dtb[0] - dtb[1]) / dtb[1]
        same_plan = sims[0].gridspec == sims[1].gridspec
        worst[limiter] = max(errs.values())
        phase("mfv_block_parity", limiter=limiter, N=sims[1].state.N,
              ticks=PARITY_STEPS, rel_err=errs, same_levels_and_schedule=
              same_ints, dt_base_rel_err=dtb_err, same_grid_plan=same_plan,
              levels=torch.bincount(sims[1].state.level).tolist())
        if worst[limiter] > PARITY_TOL or not same_ints or dtb_err > 1e-12 \
                or not same_plan:
            raise RuntimeError(f"mfv_block_parity ({limiter}) disagrees "
                               f"with the plain path: {errs}")
    phase("mfv_block_parity_done", worst=worst,
          seconds=time.perf_counter() - t0)


def _run_to(sim, t_target, max_ticks=20000):
    """main_loop_step until t >= t_target (tests/test_mfv_block.py's
    _run_to): the ticks taken."""
    n = 0
    while sim.t < t_target and n < max_ticks:
        sim.main_loop_step()
        n += 1
    if sim.t < t_target:
        raise RuntimeError(f"only reached t = {sim.t} in {n} ticks")
    return n


def mfv_block_tube(dev, card):
    """Phase 73: tests/test_mfv_block.py:61-113's tube on the grid path
    on the card in float64 (check.mfv_block_tube_params: 256 + 64, open
    ends, the simple limiter) to t = 0.1 with a global dt and with
    Nlevels 3: at least 2 occupied levels, the masses' sums equal to
    1e-13, the block run against the global one L1(v) < 2e-3 and L1(rho)
    < 1e-3 over -1 < x < 1; the block run's kernels every tick and
    against their plain versions at its end.  Returns the block run's
    counts and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_mfv_block_kernels,
                                         mfv_block_tube_params)
    from gandalf_tpu_torch.ops.mfv_grid27 import flux_count
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    runs = {}
    for nlev in (1, 3):
        sim = SimulationBase.factory(mfv_block_tube_params(nlev), dev,
                                     torch.float64)
        sim.SetupSimulation()
        torch.cuda.synchronize()
        _ext.reset_launches()
        t0 = time.perf_counter()
        ticks = _run_to(sim, MFV_BLOCK_TUBE_T)
        torch.cuda.synchronize()
        runs[nlev] = (sim, ticks, time.perf_counter() - t0)
    ref, blk = runs[1][0], runs[3][0]
    counts = {k: _ext.LAUNCHES[k] for k in (
        "grid27_bin_1d", "mfv_density_1d", "mfv_gradients_1d",
        "levelneib_1d", flux_count(blk.gridspec, blk.mfv_cfg, block=True))}

    def prof(sim):
        x = sim.state.r[:, 0].cpu().numpy()
        o = np.argsort(x)
        return (x[o], sim.state.v[:, 0].cpu().numpy()[o],
                sim.state.rho.cpu().numpy()[o])

    xr, vr, rr = prof(ref)
    xb, vb, rb = prof(blk)
    sel = (xr > -1.0) & (xr < 1.0)
    l1v = float(np.mean(np.abs(np.interp(xr, xb, vb) - vr)[sel]))
    l1r = float(np.mean(np.abs(np.interp(xr, xb, rb) - rr)[sel]))
    m_ref, m_blk = float(ref.state.m.sum()), float(blk.state.m.sum())
    levels = torch.bincount(blk.state.level.cpu()).tolist()
    ticks = runs[3][1]
    checks = {
        "two_levels": sum(1 for n in levels if n) >= 2
        and int(blk._blocksched.level_max) >= 1,
        "mass": abs(m_blk - m_ref) <= 1e-13 * abs(m_ref),
        "l1_v": l1v < MFV_BLOCK_TUBE_L1_V,
        "l1_rho": l1r < MFV_BLOCK_TUBE_L1_RHO,
        "finite": bool(torch.isfinite(blk.state.v).all()),
        "launches": all(n >= ticks for n in counts.values())
        and counts["grid27_bin_1d"] >= 2 * ticks,
    }
    rep = compare_mfv_block_kernels(blk, repeats=20)
    phase("mfv_block_tube", N=blk.state.N, t=blk.t,
          global_steps=runs[1][1], global_s=runs[1][2], block_ticks=ticks,
          block_s=runs[3][2], ticks_per_s=ticks / runs[3][2],
          levels=levels, level_max=int(blk._blocksched.level_max),
          L1_v=l1v, L1_rho=l1r, mass=[m_ref, m_blk], launches=counts,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"mfv_block_tube checks failed: {failed}")
    keep = ("levelneib_1d", flux_count(blk.gridspec, blk.mfv_cfg, block=True))
    return {k: counts[k] for k in keep}, {k: rep[k] for k in keep}


def _bound_against_oracle(sim, n_sample=MFV_BLOCK_ORACLE_N, seed=0):
    """The conservative limiter's grid bound (K32 and K33) on the card
    from the state's r, v, c and h, in float64 and in the run's own dtype
    (the bound the timed ticks use), against the all-pairs oracle
    (integrate/mfv_block.vsig_distant_dense, float64) at `n_sample`
    particles (numpy generator `seed`): the float64 bound's least margin
    bound - oracle, whether it is above -1e-10 everywhere, and its median
    ratio (tests/test_mfv_block.py:193-204); the run dtype's least margin
    and whether it is above -TOL_F32_MFV_VSIG times the largest oracle
    value in float32 (check.py's float32 rule for K32 and K33; -1e-10 in
    float64)."""
    from gandalf_tpu_torch.check import TOL_F32_MFV_VSIG
    from gandalf_tpu_torch.integrate.mfv_block import vsig_distant_dense
    from gandalf_tpu_torch.ops import active_grid as ag
    from gandalf_tpu_torch.ops import mfv_grid27 as mg
    from gandalf_tpu_torch.ops import sph_grid27 as g27

    s, spec = sim.state, sim.gridspec

    def bound(r, v, c, h):
        b = g27.bin_particles(spec, r)
        return mg.vsig_conservative(spec, ag.dense_ids(spec, b), b.cell_of,
                                    r, v, c, h)

    fields = (s.r, s.v, s.sound, s.h)
    own = bound(*(x.contiguous() for x in fields))
    r, v, c, h = (x.double().contiguous() for x in fields)
    f64 = bound(r, v, c, h)
    idx = np.sort(np.random.default_rng(seed).choice(
        s.N, size=min(n_sample, s.N), replace=False))
    rows = torch.as_tensor(idx, device=r.device)
    step = max(1, (1 << 24) // s.N)
    oracle = torch.cat([vsig_distant_dense(
        sim.box, r, v, h, c, s.alive, rows=rows[c0:c0 + step])
        for c0 in range(0, rows.numel(), step)])
    b = f64[rows]
    ratio = b / torch.clamp_min(oracle, 1e-30)
    margin = (own[rows].double() - oracle).min()
    slack = (TOL_F32_MFV_VSIG * float(oracle.abs().max())
             if s.r.dtype == torch.float32 else 1e-10)
    return {"n_sample": int(rows.numel()),
            "least_margin": float((b - oracle).min()),
            "above_oracle": bool((b >= oracle - 1e-10).all()),
            "median_ratio": float(ratio.median()),
            "run_dtype": str(s.r.dtype),
            "run_dtype_least_margin": float(margin),
            "run_dtype_slack": slack,
            "run_dtype_above_oracle": bool(margin >= -slack)}


def _block_window(sim, ticks):
    """`ticks` ticks through main_loop_step with the counts set to 0 just
    before them: (seconds, steps ended in the window)."""
    from gandalf_tpu_torch import _ext

    torch.cuda.synchronize()
    ended0 = int(sim.steps_ended)
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ticks):
        sim.main_loop_step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, int(sim.steps_ended) - ended0


def mfv_block_khi(dev, card):
    """Phase 74: the 2D box of tests/test_mfv_grid.py at x16 per axis
    (check.mfv_khi_params(512, Nlevels=3): 524,288 particles) in float32
    under the simple limiter, 2 warm-up and 32 timed ticks, then from a
    new setup under the conservative limiter, 2 warm-up and 16 timed
    ticks (tests/test_mfv_block.py:121-134's gates: finite rho and v,
    the mass exact, sum Q_E within 5e-2 of its start, level_max >= 1),
    with ticks/s, particle-updates/s, steps ended/s, the level histogram
    and the counts; K12's block mode, K22 and (conservative) K32 and K33
    every tick and against their plain versions at the run's end; the
    conservative bound against the all-pairs oracle."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_mfv_block_kernels,
                                         kernel_name, mfv_khi_params)
    from gandalf_tpu_torch.ops.mfv_grid27 import flux_count
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    launches, rep = {}, {}
    for ticks, limiter in zip(MFV_BLOCK_KHI_TICKS,
                              ("simple", "conservative")):
        t_phase = time.perf_counter()
        sim = SimulationBase.factory(
            mfv_khi_params(MFV_KHI_N, Nlevels=3, time_step_limiter=limiter),
            dev, torch.float32)
        sim.SetupSimulation()
        m0 = sim.state.m.clone()
        e0 = _mfv_energy_nd(sim.state)
        for _ in range(MFV_BLOCK_WARM):
            sim.main_loop_step()
        elapsed, ended = _block_window(sim, ticks)
        spec = sim.gridspec
        names = ["grid27_bin_2d", "mfv_density_2d", "mfv_gradients_2d",
                 "levelneib_2d", flux_count(spec, sim.mfv_cfg, block=True)]
        if limiter == "conservative":
            names += [kernel_name("mfv_vsig_near", spec),
                      kernel_name("mfv_vsig_far", spec)]
        counts = {k: _ext.LAUNCHES[k] for k in names}
        s = sim.state
        drift = abs(_mfv_energy_nd(s) - e0) / abs(e0)
        checks = {
            "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                          for f in ("r", "v", "u", "h", "rho", "Qcons0")),
            "mass_exact": bool(torch.equal(s.m, m0)),
            "no_overflow": not bool(s.neib_overflow),
            "energy": drift <= MFV_BLOCK_KHI_ENERGY_TOL,
            "level_max": int(sim._blocksched.level_max) >= 1,
            "launches": all(n >= ticks for n in counts.values())
            and counts["grid27_bin_2d"] >= 2 * ticks,
        }
        r = compare_mfv_block_kernels(sim, repeats=5)
        extra = {}
        if limiter == "conservative":
            extra["bound_vs_oracle"] = _bound_against_oracle(sim)
            checks["bound_above_oracle"] = \
                extra["bound_vs_oracle"]["above_oracle"]
            checks["run_dtype_bound_above_oracle"] = \
                extra["bound_vs_oracle"]["run_dtype_above_oracle"]
            checks["bound_median_ratio"] = \
                extra["bound_vs_oracle"]["median_ratio"] < 10.0
        RATES[f"mfv_block_khi_{limiter}"] = s.N * ticks / elapsed
        phase("mfv_block_khi", limiter=limiter, N=s.N, ticks=sim.Nsteps,
              timed_ticks=ticks, timed_s=elapsed, ticks_per_s=ticks / elapsed,
              particle_updates_per_s=s.N * ticks / elapsed,
              steps_ended_per_s=ended / elapsed,
              sim_time=sim.t, levels=torch.bincount(s.level.cpu()).tolist(),
              level_max=int(sim._blocksched.level_max),
              mfv_khi_particle_steps_per_s=RATES.get("mfv_khi_hllc_gizmo"),
              ncells=list(spec.ncells), k_cell=spec.k_cell,
              launches=counts, energy_drift=drift, checks=checks,
              kernels=r, card=card, seconds=time.perf_counter() - t_phase,
              **extra)
        failed = [k for k, ok in checks.items() if not ok]
        failed += [k for k, x in r.items() if not x["ok"]]
        if failed:
            raise RuntimeError(f"mfv_block_khi ({limiter}) checks failed: "
                               f"{failed}")
        _first_counts(launches, rep, {k: counts[k] for k in names[3:]}, r)
    return launches, rep


def mfv_block_sphere(dev, card, variant=None, tag="mfv_block_sphere",
                     energy_gate=MFV_BLOCK_SPHERE_ENERGY_TOL):
    """Phase 75 (and, with the smoothing kernel `variant`, the sphere of
    phase 108 under `tag`): the cold sphere of cold_sphere_block
    (check.mfv_block_sphere_params(262144): 258,135 particles, Nlevels
    4, the quadrupole tree, the conservative limiter) through block MFV
    in float32, block_main_path's IC: setup, 4 warm-up ticks, 32 timed
    ticks, with the rates, the level histogram and the counts (K1 twice,
    K4-K7 in the MFV zeta mode, K10, K11, K12's block mode, K22, K32
    and K33 every tick); mfv_main_path's gates (finite, rho > 0, no
    overflow, the mass exact, the tree's accuracy against the all-pairs
    mfv_smoothed_gravity, with block_main_path's bound for this sphere,
    and the drift of the predicted energy sum m (u + v^2/2) - sum m gpot
    / 2 over the window within `energy_gate`); the conservative bound
    against the oracle; the block kernels and K10-K12 against their
    plain versions at the run's end."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_mfv_block_kernels,
                                         compare_mfv_kernels, family_params,
                                         mfv_block_sphere_params,
                                         mfv_gravity_accuracy)
    from gandalf_tpu_torch.ops.mfv_grid27 import flux_count
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    params = mfv_block_sphere_params(BLOCK_N)
    if variant is not None:
        family_params(variant, params)
    sim = SimulationBase.factory(params, dev, torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation(block_ic(params))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    m0 = sim.state.m.clone()
    for _ in range(MFV_BLOCK_SPHERE_WARM):
        sim.main_loop_step()
    e0 = _predicted_energy(sim.state)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    t_sim0 = sim.t
    elapsed, ended = _block_window(sim, MFV_BLOCK_SPHERE_TICKS)
    ticks = MFV_BLOCK_SPHERE_TICKS
    kern = sim.kern
    fam = [_ext.family_count(k, kern)
           for k in ("tree_near_mfv", "mfv_density", "mfv_gradients")]
    k12 = flux_count(sim.gridspec, sim.mfv_cfg, block=True, kern=kern)
    names = ["grid27_bin", "tree_gather", "tree_build", "tree_walk", *fam,
             "levelneib", "mfv_vsig_near", "mfv_vsig_far", k12]
    counts = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    drift = abs(_predicted_energy(s) - e0) / abs(e0)
    acc = mfv_gravity_accuracy(sim, n_sample=2048)
    oracle = _bound_against_oracle(sim)
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "Qcons0",
                                "grad", "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "mass_exact": bool(torch.equal(s.m, m0)),
        "launches": all(n >= ticks for n in counts.values())
        and counts["grid27_bin"] >= 2 * ticks,
        "accuracy": acc["rms_rel_err"] <= BLOCK_ACCURACY_TOL,
        "energy_drift": drift <= energy_gate,
        "bound_above_oracle": oracle["above_oracle"],
        "run_dtype_bound_above_oracle": oracle["run_dtype_above_oracle"],
        "bound_median_ratio": oracle["median_ratio"] < 10.0,
    }
    if variant is None:
        rep = compare_mfv_block_kernels(sim, repeats=5)
        rep.update(compare_mfv_kernels(sim, s, repeats=5))
    else:
        # K22, K32 and K33 take no W: timed in the M4 run only; K12 in its
        # block mode only
        rep = compare_mfv_block_kernels(sim, repeats=5, timed_names=[k12])
        rep.update(compare_mfv_kernels(sim, s, repeats=5, flux_cfgs=[]))
    spec = sim.treespec
    phase(tag, kernel=kern.variant, N=s.N, ticks=sim.Nsteps,
          timed_ticks=ticks,
          setup_s=t_setup, timed_s=elapsed, ticks_per_s=ticks / elapsed,
          particle_updates_per_s=s.N * ticks / elapsed,
          steps_ended_per_s=ended / elapsed,
          sim_time_per_wall_s=(sim.t - t_sim0) / elapsed,
          levels=torch.bincount(s.level.cpu()).tolist(),
          level_max=int(sim._blocksched.level_max),
          rebuilds_in_window=sim._n_tree_plans - plans0
          - (sim._n_grid_overflows - replans0),
          replans_in_window=sim._n_grid_overflows - replans0,
          G_pad=spec.n_leaves, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, launches=counts, energy_drift=drift,
          energy_gate=energy_gate, accuracy=acc,
          accuracy_gate=BLOCK_ACCURACY_TOL, bound_vs_oracle=oracle,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    # with a variant: its K7, K10-K12 entries (K22, K32, K33 take no W and
    # stand in the kernel line from the M4 run)
    keep = [k12] + (fam if variant is not None
                    else ["mfv_vsig_near", "mfv_vsig_far"])
    return {k: counts[k] for k in keep}, {k: rep[k] for k in keep}


def _predicted_energy(s) -> float:
    """sum m (u + v^2/2) - sum m gpot / 2 of a block MFV state, each
    particle at its predicted state of the last tick, in float64."""
    m = s.m.double()
    kin = 0.5 * torch.sum(s.v.double() ** 2, dim=1)
    return float(torch.sum(m * (s.u.double() + kin))
                 - 0.5 * torch.sum(m * s.gpot.double()))


def radiation_kernels(dev):
    """Phase 76: K34-K37 against their plain versions on the card at the
    Spitzer HII region's shapes (258,135 particles in float32 after
    setup, K36 with the first Monte-Carlo iteration's 2,065,080 packets (8 N)
    and 256 steps) and K37 on three overlapping sources at 262,144
    particles; then the same in float64 at the parity runs' sizes (739
    particles, 4,096 packets).  Fields to 1e-5 (1e-12 in float64) of
    their largest value, K36 against its plain version with float64 sums; K37's
    flags only inside the rounding band and in at most 1e-3 of the
    particles, the counts printed.  Timed in float32 beside the bounds
    (K34's library time: index_add_).  Returns the float32 reports."""
    from gandalf_tpu_torch.check import (bound, compare_radiation_kernels,
                                         radiation_kernel_inputs,
                                         spitzer_sim, stromgren_inputs)

    t0 = time.perf_counter()
    sim = spitzer_sim(RAD_KERNEL_N, "monoionisation", dev)
    rep = compare_radiation_kernels(
        radiation_kernel_inputs(sim), repeats=5,
        stromgren=stromgren_inputs(RAD_KERNEL_N, dev, torch.float32))
    for r in rep.values():
        r["bound_ms"], r["bound_by"] = bound(r["work"], torch.float32)
    phase("radiation_kernels", N=sim.state.N, dtype="torch.float32",
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          report=rep)
    require_ok("radiation_kernels", rep)
    del sim
    small = spitzer_sim(RAD_PARITY_MC_N, "monoionisation", dev,
                        torch.float64)
    rep64 = compare_radiation_kernels(
        radiation_kernel_inputs(small, n_packets=4096),
        stromgren=stromgren_inputs(4096, dev, torch.float64))
    phase("radiation_kernels", N=small.state.N, dtype="torch.float64",
          report=rep64, seconds=time.perf_counter() - t0)
    require_ok("radiation_kernels", rep64)
    return rep


def _host_draws(device, ndim=3):
    """Monte-Carlo draws in `ndim` dims made on the host from a CPU
    torch.Generator and moved to `device`, so both devices march the same
    packets."""
    from gandalf_tpu_torch.ops.mcrt import mc_draws

    def draw(seed, ndot, n_packets, n_iter):
        gen = torch.Generator().manual_seed(seed)
        return [(src.to(device), dirs.to(device)) for src, dirs in
                mc_draws(gen, ndot.cpu(), n_packets, ndim, n_iter)]

    return draw


def radiation_parity(dev) -> None:
    """Phase 77: tests/test_torch_radiation_sim.py's configurations on
    the card in float64 against the plain path on the CPU, 3 steps each:
    the Spitzer sphere at 280 particles under ionisation (the field
    updated at the first step only: later updates rank the lattice's
    shells of equal distance by each device's rounding noise) and
    treeray, at 739 under monoionisation (cross-section 50, the draws
    made on the host), and 3 dense block ticks of ionisation (Nlevels 2).
    ionfrac equal and r, v, u, dt within 1e-9 of each field's largest
    value after every step."""
    from gandalf_tpu_torch.check import spitzer_sim

    t0 = time.perf_counter()
    cases = {"ionisation": ("ionisation", RAD_PARITY_N,
                            {"nradstep": RAD_PARITY_STEPS}),
             "treeray": ("treeray", RAD_PARITY_N, {}),
             "monoionisation": ("monoionisation", RAD_PARITY_MC_N,
                                {"Nraditerations": 2}),
             "block_ionisation": ("ionisation", RAD_PARITY_N,
                                  {"Nlevels": 2,
                                   "nradstep": RAD_PARITY_STEPS})}
    results = {}
    for tag, (scheme, n, over) in cases.items():
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = spitzer_sim(n, scheme, device, torch.float64, **over)
            if scheme == "monoionisation":
                sim.mc_across = RAD_PARITY_MC_ACROSS
                sim.mc_draw_fn = _host_draws(device)
            sims.append(sim)
        errs, same_ion = {}, True
        for _ in range(RAD_PARITY_STEPS):
            for sim in sims:
                sim.main_loop_step()
            a, b = (x.state for x in sims)
            same_ion &= bool(torch.equal(a.ionfrac.cpu(), b.ionfrac))
            for f in ("r", "v", "u"):
                want = getattr(b, f)
                err = float(torch.abs(getattr(a, f).cpu() - want).max()
                            / torch.abs(want).max())
                errs[f] = max(errs.get(f, 0.0), err)
            errs["dt"] = max(errs.get("dt", 0.0), abs(float(a.dt)
                                                      - float(b.dt))
                             / abs(float(b.dt)))
        results[tag] = {"rel_err": errs, "same_ionfrac": same_ion,
                        "ionised": int((sims[1].state.ionfrac > 0.5).sum()),
                        "N": sims[1].state.N}
        if not same_ion or max(errs.values()) > PARITY_TOL:
            phase("radiation_parity", cases=results)
            raise RuntimeError(f"radiation_parity {tag}: the card parts "
                               f"from the plain path: {results[tag]}")
    phase("radiation_parity", steps=RAD_PARITY_STEPS, cases=results,
          seconds=time.perf_counter() - t0)


def _spitzer_path(dev, card, scheme):
    """Phases 78-80: the Spitzer HII region at 258,135 particles in
    float32 under `scheme`: setup, then SPITZER_STEPS steps, each with its
    radiation update (the counts set to 0 just before them); the first
    update's front (tests/test_spitzer.py's 97th percentile of the
    ionised particles' distance) within SPITZER_FRONT_TOL of Rs, or for
    monoionisation (cross-section check.SPITZER_MC_ACROSS, 10
    iterations as tests/test_mcrt.py runs them) the radius of the
    ionised particles' volume within 15% of Rs; finite u, 0 <= ionfrac <= 1, the scheme's kernels every
    step; the rate and one update's device time (CUDA events).  Returns
    the scheme's launches."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (SPITZER_RS, front_radius,
                                         ionised_radius, spitzer_sim)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sim = spitzer_sim(SPITZER_N, scheme, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    names = RADIATION[scheme]
    _ext.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.main_loop_step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    front = front_radius(sim)
    r_ion = ionised_radius(sim)
    for _ in range(SPITZER_STEPS - 1):
        sim.main_loop_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    N = s.N
    # one more update, timed on the device, from the final state
    saved = s
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sim._radiation_update()
    stop.record()
    torch.cuda.synchronize()
    update_ms = start.elapsed_time(stop)
    sim.state = saved
    alive = s.alive
    if scheme == "monoionisation":
        gate = abs(r_ion / SPITZER_RS - 1.0) <= SPITZER_MC_RADIUS_TOL
    else:
        gate = abs(front - SPITZER_RS) < SPITZER_FRONT_TOL[scheme]
    checks = {
        "front": gate,
        "finite_u": bool(torch.isfinite(s.u[alive]).all()),
        "ionfrac_in_0_1": bool(((s.ionfrac >= 0) & (s.ionfrac <= 1)).all()),
        "some_neutral": bool((s.ionfrac[alive] < 0.5).any()),
        "launches": all(n >= SPITZER_STEPS for n in launches.values()),
    }
    tag = {"ionisation": "spitzer_ionisation", "treeray": "spitzer_treeray",
           "monoionisation": "spitzer_mcrt"}[scheme]
    phase(tag, N=N, steps=SPITZER_STEPS, setup_s=t_setup,
          first_step_s=first_s, timed_s=elapsed,
          particle_steps_per_s=N * SPITZER_STEPS / elapsed,
          update_device_ms=update_ms, Rs=SPITZER_RS, front_radius=front,
          ionised_volume_radius=r_ion,
          ionised=int((s.ionfrac > 0.5).sum()),
          mc_across=getattr(sim, "mc_across", None),
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          t_code=sim.t, dt_code=float(s.dt), launches=launches,
          checks=checks, card=card, seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# 81-86: block timesteps on the 1D and 2D grid path
# ---------------------------------------------------------------------------

def active_kernels_dims(dev) -> None:
    """Phase 81: K8 and K9 at ndim 1 and 2 against their plain versions
    (check.compare_active_kernels) on the block Sod tube's state in
    float64 and on the KHI's (x4 per axis, Nlevels 3) in float64 and
    float32, each for a random eighth of the particles and for all of
    them; levelneib exactly equal."""
    from gandalf_tpu_torch.check import (block_sod_params,
                                         compare_active_kernels, khi_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    for name, make, dtypes in (
            ("tube", lambda: block_sod_params(4), (torch.float64,)),
            ("khi", lambda: khi_params(DIMS_ACTIVE_KHI_SCALE, nlevels=3),
             (torch.float64, torch.float32))):
        for dtype in dtypes:
            sim = GradhSphSimulation(make(), device=dev, dtype=dtype)
            sim.SetupSimulation()
            N = sim.state.N
            eighth = np.sort(np.random.default_rng(1).choice(
                N, N // 8, replace=False))
            for subset, idx in (("eighth", eighth), ("all", np.arange(N))):
                rep = compare_active_kernels(
                    sim, sim.state, torch.as_tensor(idx, dtype=torch.int32,
                                                    device=dev))
                phase("active_kernels", case=name, ndim=sim.ndim, N=N,
                      dtype=str(dtype), subset=subset,
                      k_cell=sim.gridspec.k_cell, report=rep)
                require_ok("active_kernels", rep)
    phase("active_kernels_dims_done", seconds=time.perf_counter() - t0)


def block_dims_parity(dev) -> None:
    """Phase 82: float64 on the card against the plain path on the CPU,
    BLOCK_DIMS_PARITY_TICKS compacted ticks each of the block Sod tube
    (Nlevels 4) and the small KHI (Nlevels 3): the same listed rows,
    levels and grid plans every tick, fields within PARITY_TOL."""
    from gandalf_tpu_torch.check import block_sod_params, khi_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    for name, make in (("tube", lambda: block_sod_params(4)),
                       ("khi", lambda: khi_params(1, nlevels=3))):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = GradhSphSimulation(make(), device=device,
                                     dtype=torch.float64)
            sim.SetupSimulation()
            sims.append(sim)
        same = True
        rows = []
        for _ in range(BLOCK_DIMS_PARITY_TICKS):
            for sim in sims:
                sim.main_loop_step()
            same &= sims[0].last_tick_rows == sims[1].last_tick_rows
            same &= bool(torch.equal(sims[0].state.level.cpu(),
                                     sims[1].state.level))
            same &= sims[0].gridspec == sims[1].gridspec
            rows.append(list(sims[1].last_tick_rows))
        torch.cuda.synchronize()
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "a"))
        replans = [s._n_grid_overflows for s in sims]
        phase("block_dims_parity", case=name, ndim=sims[1].ndim,
              N=sims[1].state.N, ticks=BLOCK_DIMS_PARITY_TICKS,
              rel_err=errs, same_rows_levels_and_plans=same,
              rows=rows, replans=replans,
              levels=torch.bincount(sims[1].state.level).tolist())
        if max(errs.values()) > PARITY_TOL or not same \
                or replans[0] != replans[1]:
            raise RuntimeError(f"block_dims_parity ({name}): kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same} {replans}")
    phase("block_dims_parity_done", seconds=time.perf_counter() - t0)


def _run_block(params, dev, t_target):
    """A float64 run on the card to t_target: (sim, ticks, seconds)."""
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    sim = GradhSphSimulation(params, device=dev, dtype=torch.float64)
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = _run_to(sim, t_target)
    torch.cuda.synchronize()
    return sim, ticks, time.perf_counter() - t0


def block_sod_tube(dev, card):
    """Phase 83: tests/test_block.py's gates through the port on the card
    in float64.  The block tube (check.block_sod_params(4): 256 + 64,
    periodic, the compacted tick) to t = 0.25 (:131-155): L1(vx) < 0.02,
    at least two levels occupied, and the listed rows of every active
    pass over N ticks < 0.8 (the port lists no pads); its counts set to 0
    just before it.  Then :90-103: Nlevels 3 against a global run to t =
    0.2, median |drho|/rho < 5e-3 and max < 0.08.  K8 and K9 (1D)
    against their plain versions at the tube's end.  Returns the tube's
    launches and the reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (block_sod_params,
                                         compare_active_kernels, sod_l1)

    t_phase = time.perf_counter()
    names = ("grid27_bin_1d", "active_density_1d", "active_forces_1d")
    _ext.reset_launches()
    sim, ticks, elapsed = _run_block(block_sod_params(4), dev, BLOCK_TUBE_T)
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    N = s.N
    l1 = sod_l1(sim)
    frac = sim.active_rows / (N * ticks)
    levels = torch.bincount(s.level.cpu()).tolist()
    runs = {nl: _run_block(block_sod_params(nl, tend=BLOCK_GLOBAL_T), dev,
                           BLOCK_GLOBAL_T) for nl in (1, 3)}
    rho_g = runs[1][0].state.rho.cpu().numpy()
    rho_b = runs[3][0].state.rho.cpu().numpy()
    rel = np.abs(rho_b - rho_g) / rho_g
    checks = {
        "l1_vx": l1 < BLOCK_TUBE_L1,
        "two_levels": sum(1 for n in levels if n) >= 2,
        "compacts": frac < BLOCK_TUBE_FRACTION,
        "finite": bool(torch.isfinite(s.v).all()),
        "launches": all(launches[k] >= ticks for k in names),
        "block_vs_global": float(np.median(rel)) < BLOCK_GLOBAL_MEDIAN
        and float(rel.max()) < BLOCK_GLOBAL_MAX,
    }
    active = torch.nonzero(s.nlast == sim._blocksched.n).flatten().to(
        torch.int32)
    rep = compare_active_kernels(sim, s, active, repeats=20)
    phase("block_sod_tube", N=N, t=sim.t, ticks=ticks, timed_s=elapsed,
          ticks_per_s=ticks / elapsed, L1_vx=l1, listed_row_fraction=frac,
          levels=levels, launches=launches,
          block_vs_global={"ticks": [runs[1][1], runs[3][1]],
                           "median": float(np.median(rel)),
                           "max": float(rel.max())},
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"block_sod_tube checks failed: {failed}")
    keep = names[1:]
    return {k: launches[k] for k in keep}, {k: rep[k] for k in keep}


def _compacted_window(tag, sim, card, warm, timed, gates, t_setup,
                      t_phase, all_rows=False):
    """Warm-up ticks, then `timed` ticks with the counts set to 0 just
    before them (t_setup: the setup's seconds; t_phase: the phase's
    start); the rates, the level histogram, the listed-row fraction,
    K8 and K9 (2D) launches a tick, the energy drift and `gates` (names:
    finite, rho_positive, no_overflow, mass_exact, energy_drift with its
    bound, two_levels, compacts with its bound), then K8 and K9 against
    their plain versions at the path's end for the particles just active
    (with `all_rows`, for every particle, as most of the path's passes
    list them).  Returns the counts and the reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_active_kernels

    for _ in range(warm):
        sim.main_loop_step()
    s = sim.state
    N = s.N
    m0 = float(s.m.double().sum())
    e0 = energy(s)
    rows0, replans0 = sim.active_rows, sim._n_grid_overflows
    first = []
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed):
        sim.main_loop_step()
        first.append(sim.last_tick_rows[0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    names = ("grid27_bin_2d", "active_density_2d", "active_forces_2d")
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    rows = sim.active_rows - rows0
    frac = rows / (N * timed)
    drift = abs(energy(s) - e0) / abs(e0)
    levels = torch.bincount(s.level.cpu()).tolist()
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "mass_exact": float(s.m.double().sum()) == m0,
        "launches": all(launches[k] >= timed for k in names[1:]),
    }
    if "energy_drift" in gates:
        checks["energy_drift"] = drift <= gates["energy_drift"]
    if "two_levels" in gates:
        checks["two_levels"] = sum(1 for n in levels if n) >= 2
    if "compacts" in gates:
        checks["compacts"] = frac < gates["compacts"]
    listed = (torch.ones_like(s.alive) if all_rows
              else s.nlast == sim._blocksched.n)
    rep = compare_active_kernels(
        sim, s, torch.nonzero(listed).flatten().to(torch.int32), repeats=5)
    phase(tag, N=N, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, ticks=sim.Nsteps, timed_ticks=timed,
          setup_s=t_setup, timed_s=elapsed, ticks_per_s=timed / elapsed,
          active_updates_per_s=rows / elapsed, t_code=sim.t,
          listed_rows=rows, listed_row_fraction=frac, first_pass_rows=first,
          levels=levels, level_max=int(sim._blocksched.level_max),
          launches=launches,
          launches_per_tick={k: n / timed for k, n in launches.items()},
          replans_in_window=sim._n_grid_overflows - replans0,
          energy_drift=drift, checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")
    return launches, rep


def block_khi_2d(dev, card):
    """Phase 84: the KHI at full width (check.khi_params(16), 425,984
    particles) with Nlevels 3, level_diff_max 1, in float32 on the
    compacted tick: BLOCK_KHI_WARM warm-up and BLOCK_KHI_TICKS timed
    ticks; finite, rho > 0, no unresolved overflow, mass exact, energy
    drift within BLOCK_ENERGY_DRIFT_TOL; K8 and K9 (2D) against their
    plain versions for every particle, as most ticks list them.  Returns
    the K8 and K9 (2D) counts and reports."""
    from gandalf_tpu_torch.check import khi_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    sim = GradhSphSimulation(khi_params(KHI_SCALE, nlevels=3), device=dev,
                             dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    launches, rep = _compacted_window(
        "block_khi_2d", sim, card, BLOCK_KHI_WARM, BLOCK_KHI_TICKS,
        {"energy_drift": BLOCK_ENERGY_DRIFT_TOL}, time.perf_counter() - t0,
        t_phase, all_rows=True)
    keep = ("active_density_2d", "active_forces_2d")
    return {k: launches[k] for k in keep}, {k: rep[k] for k in keep}


def sedov_block_2d(dev, card) -> None:
    """Phase 85: the 2D Sedov blast (check.sedov_params at 512^2 =
    262,144 particles, box [-1, 1]^2 periodic, kefrac 0.3, smooth_ic 1)
    with Nlevels 5, level_diff_max 1, in float32: SEDOV_WARM warm-up and
    SEDOV_TICKS timed ticks; at least two levels, listed rows over N
    ticks below SEDOV_FRACTION, finite, rho > 0, mass exact; the energy
    drift reported."""
    from gandalf_tpu_torch.check import sedov_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    sim = GradhSphSimulation(sedov_params(SEDOV_N, SEDOV_NLEVELS),
                             device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    _compacted_window("sedov_block_2d", sim, card, SEDOV_WARM, SEDOV_TICKS,
                      {"two_levels": True, "compacts": SEDOV_FRACTION},
                      time.perf_counter() - t0, t_phase)


def dustybox_block(dev, card) -> None:
    """Phase 86: tests/test_dust.py:112-133 through the port on the card
    (check.dustybox_block_params: the 1D two-fluid box, Nlevels 3,
    level_diff_max 1, the dense dust tick) in float64 to t = 1: gas and
    dust mean v_x within DUSTYBOX_GATE of the analytic exponential,
    momentum 1 to 1e-12, E = 2 to rel 1e-5."""
    from gandalf_tpu_torch.check import dustybox_block_params

    t_phase = time.perf_counter()
    sim, ticks, elapsed = _run_block(dustybox_block_params(),
                                     dev, DUSTYBOX_BLOCK_T)
    vg, vd, mom, e = _box_means(sim)
    dv = math.exp(-sim.t)
    errs = {"gas": abs(vg - (0.5 - 0.5 * dv)),
            "dust": abs(vd - (0.5 + 0.5 * dv)),
            "momentum": abs(mom - 1.0), "energy": abs(e - 2.0) / 2.0}
    checks = {"use_block": sim.use_block and sim.has_dust,
              "gas": errs["gas"] < DUSTYBOX_GATE,
              "dust": errs["dust"] < DUSTYBOX_GATE,
              "momentum": errs["momentum"] < 1e-12,
              "energy": errs["energy"] < 1e-5}
    phase("dustybox_block", N=sim.state.N, t=sim.t, ticks=ticks,
          ticks_per_s=ticks / elapsed,
          levels=torch.bincount(sim.state.level.cpu()).tolist(),
          errors=errs, checks=checks, card=card,
          seconds=time.perf_counter() - t_phase)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dustybox_block checks failed: {failed}")


def _with_bounds(rep):
    """Each report of `rep` with its bound (check.bound) in its dtype."""
    from gandalf_tpu_torch.check import bound

    for r in rep.values():
        if "work" in r:
            dtype = {"torch.float64": torch.float64}.get(r.get("dtype"),
                                                         torch.float32)
            r["bound_ms"], r["bound_by"] = bound(r["work"], dtype)
    return rep


def tree_kernels_dims(dev) -> None:
    """Phase 87: K4-K7 at NDIM 1 and 2 against their plain versions on
    the card in float64 (K4 exact, K5 within 1e-12 of each level's scale,
    K6 and K7 within 1e-10; check.compare_tree_kernels_dims): the disc
    and the rod of check.disc_params at about TREE_DIMS_N particles, each
    stepped twice, in every walk option (the geometric quadrupole walk
    and its group-list launches, gadget2, eigenmac, the fast quadrupole,
    the quintic kernel with its list launch, K7's MFV zeta mode), with
    a forced overflow each; ms a launch, the plain version's ms and the
    bound of each."""
    from gandalf_tpu_torch.check import compare_tree_kernels_dims

    t0 = time.perf_counter()
    for ndim in (2, 1):
        rep = _with_bounds(compare_tree_kernels_dims(
            ndim, dev, torch.float64, TREE_DIMS_N, repeats=3))
        phase("tree_kernels_dims", ndim=ndim, dtype="torch.float64",
              report=rep)
        require_ok("tree_kernels_dims", rep)
    phase("tree_kernels_dims_done", seconds=time.perf_counter() - t0)


def _gravity_2d_checks(s, launches, steps, acc=None, gate=None,
                       drift=None, drift_gate=None):
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow)
        and not (acc or {}).get("overflow", False),
        "launches": all(n >= steps for n in launches.values()),
    }
    if acc is not None:
        checks["accuracy"] = acc["rms_rel_err"] <= gate
    if drift is not None:
        checks["energy_drift"] = drift <= drift_gate
    return checks


def _raise_failed(tag, checks, rep):
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"{tag} checks failed: {failed}")


def _ms_per_step(launches, rep, steps):
    """Device ms a step of each kernel: its ms a launch (timed at the
    path's state) times its launches a step."""
    return {k: rep[k]["ms"] * n / steps for k, n in launches.items()
            if k in rep and "ms" in rep[k]}


GRAVITY_2D = ("grid27_bin_2d", "grid27_density_2d", "grid27_forces_2d",
              "tree_gather_2d", "tree_build_2d", "tree_walk_2d",
              "tree_near_2d")
BLOCK_2D = ("grid27_bin_2d", "active_density_2d", "active_forces_2d",
            "tree_gather_2d", "tree_build_2d", "tree_walk_list_2d",
            "tree_near_list_2d")
MFV_2D = ("grid27_bin_2d", "tree_gather_2d", "tree_build_2d",
          "tree_walk_2d", "tree_near_mfv_2d", "mfv_density_2d",
          "mfv_gradients_2d", "mfv_fluxes_2d")


def gravity_disc_2d(dev, card):
    """Phase 88: the 2D self-gravitating disc at full width
    (check.disc_params(DISC_N, 2): 262,144 particles on a square-lattice
    disc of radius 1 and mass 1, press1 1e-4, gamma 5/3, M4 grad-h,
    energy_eqn, mon97, the quadrupole tree with the geometric MAC at
    theta^2 0.1 over KD buckets of 32 rebuilt every 32 steps) in float32
    under a global dt: setup, DISC_STEPS_WARM warm-up and
    DISC_STEPS_TIMED timed steps with the counts set to 0 just before
    them; particle-steps/s, each kernel's device ms a step, finite, rho
    > 0, every kernel launched each step, no overflow, the energy drift
    within DISC_ENERGY_DRIFT_TOL and the tree at 2,048 sampled particles
    against the float64 all-pairs sum within DISC_ACCURACY_TOL (a
    monopole walk's reading beside it); then K1-K7 (2D) against their
    plain versions at the path's state.  Returns the counts and the
    reports of K1-K7 (2D)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_kernels,
                                         compare_tree_kernels, disc_params,
                                         gravity_accuracy)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = disc_params(DISC_N, 2)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(block_ic(params))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, DISC_STEPS_WARM)
    e0 = energy(sim.state, gravity=True)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    _ext.reset_launches()
    elapsed = run_timed(sim, DISC_STEPS_TIMED)
    launches = {k: _ext.LAUNCHES[k] for k in GRAVITY_2D}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = sim.state
    N = s.N
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    acc = gravity_accuracy(sim, n_sample=2048)
    mono = gravity_accuracy(sim, n_sample=2048, spec=dataclasses.replace(
        sim.treespec, quadrupole=False))
    checks = _gravity_2d_checks(s, launches, DISC_STEPS_TIMED, acc,
                                DISC_ACCURACY_TOL, drift,
                                DISC_ENERGY_DRIFT_TOL)
    rep = compare_kernels(sim, s, repeats=5)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    rep = _with_bounds(rep)
    spec = sim.treespec
    RATES["gravity_2d"] = N * DISC_STEPS_TIMED / elapsed
    phase("gravity_disc_2d", N=N, steps=sim.Nsteps,
          timed_steps=DISC_STEPS_TIMED, ic_s=_BLOCK_IC[(DISC_N, 2)][1],
          setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * DISC_STEPS_TIMED / elapsed,
          device_ms_per_step=_ms_per_step(launches, rep, DISC_STEPS_TIMED),
          rebuilds_in_window=sim._n_tree_plans - plans0,
          replans_in_window=sim._n_grid_overflows - replans0,
          G_pad=spec.n_leaves, depth=spec.depth, near_cap=spec.near_cap,
          support_cap=spec.support_cap, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, launches=launches,
          energy_drift=drift, energy_gate=DISC_ENERGY_DRIFT_TOL,
          accuracy=acc, monopole_accuracy=mono,
          accuracy_gate=DISC_ACCURACY_TOL, checks=checks, kernels=rep,
          card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("gravity_disc_2d", checks, rep)
    keep = GRAVITY_2D[3:]
    return {k: launches[k] for k in keep}, {k: rep[k] for k in keep}


def gravity_block_disc_2d(dev, card):
    """Phase 89: the same disc (its IC) under Nlevels 4, level_diff_max 1
    in float32 on the compacted tick (K1, K8, K9 over the active rows,
    K4 and K5 over all buckets, K6 and K7 over the active buckets' list):
    DISC_BLOCK_TICKS_WARM warm-up and DISC_BLOCK_TICKS_TIMED timed ticks
    with the counts set to 0 just before them; ticks/s, active
    particle-updates/s, the levels, finite, rho > 0, no overflow, at
    least two levels, K8, K9 and the list K6/K7 launched each tick, the
    energy drift (gpot from a full tree pass at both ends) within
    DISC_BLOCK_ENERGY_DRIFT_TOL and the tree at 2,048 sampled active
    particles against the float64 all-pairs sum within
    DISC_BLOCK_ACCURACY_TOL; then the list K6/K7 and K8, K9 (2D) against
    their plain versions at the path's state.  Returns the counts and
    reports of the list K6 and K7 (2D)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_active_kernels,
                                         disc_params, gravity_accuracy)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = disc_params(DISC_N, 2, nlevels=4)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    sim.SetupSimulation(block_ic(params))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    N = sim.state.N
    for _ in range(DISC_BLOCK_TICKS_WARM):
        sim.main_loop_step()
    e0 = full_gravity_energy(sim)
    rows0, replans0 = sim.active_rows, sim._n_grid_overflows
    first = []
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(DISC_BLOCK_TICKS_TIMED):
        sim.main_loop_step()
        first.append(sim.last_tick_rows[0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in BLOCK_2D}
    s = sim.state
    rows = sim.active_rows - rows0
    drift = abs(full_gravity_energy(sim) - e0) / abs(e0)
    active = torch.nonzero(s.nlast == sim._blocksched.n).flatten().to(
        torch.int32)
    acc = gravity_accuracy(sim, n_sample=2048, among=active)
    levels = torch.bincount(s.level.cpu()).tolist()
    per_tick = {k: launches[k] for k in BLOCK_2D
                if k.startswith(("active", "tree_walk", "tree_near"))}
    checks = _gravity_2d_checks(s, per_tick, DISC_BLOCK_TICKS_TIMED, acc,
                                DISC_BLOCK_ACCURACY_TOL, drift,
                                DISC_BLOCK_ENERGY_DRIFT_TOL)
    checks["two_levels"] = sum(1 for n in levels if n) >= 2
    rep = _with_bounds(compare_active_kernels(sim, s, active, repeats=5))
    phase("gravity_block_disc_2d", N=N, ticks=sim.Nsteps,
          timed_ticks=DISC_BLOCK_TICKS_TIMED, setup_s=t_setup,
          timed_s=elapsed, ticks_per_s=DISC_BLOCK_TICKS_TIMED / elapsed,
          active_updates_per_s=rows / elapsed, listed_rows=rows,
          listed_row_fraction=rows / (N * DISC_BLOCK_TICKS_TIMED),
          first_pass_rows=first, levels=levels,
          level_max=int(sim._blocksched.level_max), launches=launches,
          energy_drift=drift, energy_gate=DISC_BLOCK_ENERGY_DRIFT_TOL,
          accuracy=acc, accuracy_gate=DISC_BLOCK_ACCURACY_TOL,
          replans_in_window=sim._n_grid_overflows - replans0,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("gravity_block_disc_2d", checks, rep)
    keep = ("tree_walk_list_2d", "tree_near_list_2d")
    return {k: launches[k] for k in keep}, {k: rep[k] for k in keep}


def gravity_box_2d(dev, card) -> None:
    """Phase 90: the 2D periodic box (check.slice_params(GBOX_SIDE,
    self_gravity=1, ndim=2): 65,536 particles, ewald = 0, the jittered
    lattice) in float32, GBOX_STEPS steps: K4 unwraps each bucket along
    both axes; finite, rho > 0, no overflow, K1-K7 (2D) every step, the
    energy drift and the tree's accuracy reported; then K4-K7 (2D)
    against their plain versions at the path's state."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_tree_kernels,
                                         gravity_accuracy, jittered_box_ic,
                                         slice_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    params = slice_params(GBOX_SIDE, self_gravity=1, ndim=2)
    sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
    sim.SetupSimulation(jittered_box_ic(params, GBOX_SIDE))
    e0 = energy(sim.state, gravity=True)
    _ext.reset_launches()
    elapsed = run_timed(sim, GBOX_STEPS)
    launches = {k: _ext.LAUNCHES[k] for k in GRAVITY_2D}
    s = sim.state
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    checks = _gravity_2d_checks(s, launches, GBOX_STEPS)
    checks["ewald_off"] = not sim.use_ewald \
        and tuple(sim.box.periodic_dims()) == (0, 1)
    rep = _with_bounds(compare_tree_kernels(sim, s, repeats=3))
    phase("gravity_box_2d", N=s.N, steps=sim.Nsteps, timed_s=elapsed,
          particle_steps_per_s=s.N * GBOX_STEPS / elapsed,
          launches=launches, energy_drift=drift,
          accuracy=gravity_accuracy(sim, n_sample=2048),
          G_pad=sim.treespec.n_leaves, near_cap=sim.treespec.near_cap,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("gravity_box_2d", checks, rep)


def mfv_gravity_disc_2d(dev, card):
    """Phase 91: the 2D disc (check.disc_params(MFV_DISC_N, 2, sim =
    mfvmuscl): about 65,536 particles) through MUSCL MFV with
    self-gravity (K7's MFV zeta mode) in float32, one step, then
    MFV_DISC_STEPS steps with the counts set to 0 just before them (the
    energy drift over them reported): finite, rho > 0, the
    mass exact, no overflow, K1 (twice), K4-K7 and K10-K12 (2D) every
    step; then K10-K12 and the MFV K7 (2D)
    against their plain versions at the path's state.  Returns the
    count and report of tree_near_mfv_2d."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_mfv_kernels, disc_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t_phase = time.perf_counter()
    params = disc_params(MFV_DISC_N, 2, sim="mfvmuscl")
    sim = SimulationBase.factory(params, dev, torch.float32)
    sim.SetupSimulation(block_ic(params))
    m0 = sim.state.m.clone()
    # one step first: the setup leaves gpot unset
    run_timed(sim, 1)
    e0 = _mfv_energy_nd(sim.state, gravity=True)
    _ext.reset_launches()
    elapsed = run_timed(sim, MFV_DISC_STEPS)
    launches = {k: _ext.LAUNCHES[k] for k in MFV_2D}
    s = sim.state
    every = {k: n >= (2 if k == "grid27_bin_2d" else 1) * MFV_DISC_STEPS
             for k, n in launches.items()}
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "Qcons0",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "mass_exact": bool(torch.equal(s.m, m0)),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(every.values()),
    }
    rep = _with_bounds(compare_mfv_kernels(sim, s, repeats=3))
    phase("mfv_gravity_disc_2d", N=s.N, steps=sim.Nsteps, timed_s=elapsed,
          particle_steps_per_s=s.N * MFV_DISC_STEPS / elapsed,
          launches=launches,
          energy_drift=abs(_mfv_energy_nd(s, gravity=True) - e0)
          / abs(e0),
          G_pad=sim.treespec.n_leaves, checks=checks, kernels=rep,
          card=card, seconds=time.perf_counter() - t_phase)
    _raise_failed("mfv_gravity_disc_2d", checks, rep)
    k = "tree_near_mfv_2d"
    return {k: launches[k]}, {k: rep[k]}


def gravity_dims_parity(dev):
    """Phase 92: float64 on the card against the plain path on the CPU,
    DIMS_GRAVITY_PARITY_STEPS steps (ticks) each of the 2D disc at about
    2,000 particles under a global dt and under Nlevels 4, and of the 1D
    rod at 4,096: fields within PARITY_TOL, the same tree plans, levels
    and (block) listed rows after every step.  The card's 1D run is the
    1D tree's path: its counts are set to 0 just before it, and K4-K7
    (1D) are held against their plain versions at its end.  Returns the
    1D counts and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_tree_kernels, disc_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    names = ("tree_gather_1d", "tree_build_1d", "tree_walk_1d",
             "tree_near_1d")
    launches, rep = {}, {}
    for tag, ndim, n, nlevels in DIMS_GRAVITY_PARITY:
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = GradhSphSimulation(disc_params(n, ndim, nlevels, 4),
                                     device=device, dtype=torch.float64)
            sim.SetupSimulation()
            sims.append(sim)
        same = True
        if ndim == 1:
            _ext.reset_launches()
        for _ in range(DIMS_GRAVITY_PARITY_STEPS):
            for sim in sims:
                sim.last_tick_rows = []
                sim.main_loop_step()
            same &= sims[0].last_tick_rows == sims[1].last_tick_rows
            same &= bool(torch.equal(sims[0].state.level.cpu(),
                                     sims[1].state.level))
            same &= sims[0].treespec == sims[1].treespec
        torch.cuda.synchronize()
        if ndim == 1:
            launches = {k: _ext.LAUNCHES[k] for k in names}
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot", "a"))
        plans = [s._n_tree_plans for s in sims]
        phase("gravity_dims_parity", case=tag, ndim=ndim, N=sims[1].state.N,
              steps=DIMS_GRAVITY_PARITY_STEPS, rel_err=errs,
              same_plans_levels_and_rows=same, tree_plans=plans,
              levels=torch.bincount(sims[1].state.level).tolist())
        if max(errs.values()) > PARITY_TOL or not same \
                or plans[0] != plans[1]:
            raise RuntimeError(f"gravity_dims_parity ({tag}): kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same} {plans}")
        if ndim == 1:
            rep = _with_bounds(compare_tree_kernels(sims[0], sims[0].state,
                                                    repeats=5))
            checks = {"launches": all(launches[k] >= DIMS_GRAVITY_PARITY_STEPS
                                      for k in names)}
            phase("rod_1d_kernels", N=sims[0].state.N, launches=launches,
                  checks=checks, kernels=rep)
            _raise_failed("rod_1d_kernels", checks, rep)
    phase("gravity_dims_parity_done", seconds=time.perf_counter() - t0)
    return launches, {k: rep[k] for k in names}


def sink_kernels_dims(dev) -> None:
    """Phase 93: K14 (1D), K16, K17, K18 and K20 (both launches) at NDIM 1
    and 2 against their plain versions on the card, on
    check.sink_kernel_inputs (check.smooth_accretion_inputs for K20) at
    4,096 gas with 16 and with 64 slots, in float64 and float32: K17's row
    and index exactly, K18's eaten mask and K20's claims exactly, the
    sums within 1e-10 of their largest value in float64 (check.py's
    float32 tolerances); K14 on the slots' stars.  ms a launch, plain
    ms and the bound of each at 64 slots in float32, K17's torch.argmax
    beside it."""
    from gandalf_tpu_torch.check import (compare_nbody_kernels,
                                         compare_sink_kernels,
                                         compare_td_sink_kernels,
                                         sink_kernel_inputs,
                                         smooth_accretion_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory

    t0 = time.perf_counter()
    for ndim in (2, 1):
        kern = kernel_factory("m4", ndim)
        for n, ns in SINK_DIMS_SIZES:
            for dtype in (torch.float64, torch.float32):
                timed = ns == SINK_DIMS_SIZES[-1][1] \
                    and dtype == torch.float32
                repeats = 5 if timed else 0
                rep = compare_sink_kernels(
                    kern, sink_kernel_inputs(n, ns, dev, dtype, ndim=ndim),
                    repeats=repeats)
                rep.update(compare_td_sink_kernels(
                    kern, smooth_inputs=smooth_accretion_inputs(
                        n, ns, dev, dtype, ndim=ndim), repeats=repeats))
                if ndim == 1:
                    st = sink_kernel_inputs(n, ns, dev, dtype,
                                            ndim=1)["sinks"]
                    rep.update(compare_nbody_kernels(
                        st.r, st.v, st.m, st.h, kern, repeats=repeats,
                        which=("direct_softened",)))
                if timed:
                    rep = _with_bounds(rep)
                phase("sink_kernels_dims", ndim=ndim, N=n, Ns=ns,
                      dtype=str(dtype), report=rep)
                require_ok("sink_kernels_dims", rep)
    phase("sink_kernels_dims_done", seconds=time.perf_counter() - t0)


def _sink_checks(sim, mass0, mass1, rows, launches, per_step, acc, gate,
                 sinks0, min_sinks):
    """The sink paths' gates: alive fields finite, rho > 0, dead gas at
    rest and massless, gas plus sink mass within BB_MASS_TOL, each call's
    sink gain within BB_LEDGER_TOL of what the gas gave up, no unresolved
    overflow, each sink kernel launched `per_step[k]` times a call of the
    sink step, the tree's accuracy within `gate` (acc None: no tree), at
    least `min_sinks` sinks formed (None: no creation)."""
    from gandalf_tpu_torch.check import ledger_errors

    s = sim.state
    st, alive = s.sinks, s.alive
    act = st.active
    dead = ~alive
    em, ep, m_dead = ledger_errors(rows)
    calls = len(rows)
    fields = ("r", "v", "a", "u", "h", "rho") + (
        ("gpot",) if sim.self_gravity else ())
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[alive]).all())
                      for f in fields)
        and all(bool(torch.isfinite(getattr(st, f)[act]).all())
                for f in ("r", "v", "a", "m")),
        "rho_positive": bool((s.rho[alive] > 0).all()),
        "dead_at_rest": bool((s.m[dead] == 0).all())
        and bool((s.v[dead] == 0).all()) and bool((s.a[dead] == 0).all()),
        "mass_conserved": abs(mass1 - mass0) / mass0 <= BB_MASS_TOL,
        "ledger": calls > 0 and max(em + ep) <= BB_LEDGER_TOL,
        "no_overflow": not bool(s.neib_overflow)
        and not (acc or {}).get("overflow", False),
        "sink_kernels_each_step": all(launches[k] == n * calls
                                      for k, n in per_step.items()),
    }
    if min_sinks is not None:
        checks["sinks_formed"] = int(act.sum()) - sinks0 >= min_sinks
    if acc is not None:
        checks["accuracy"] = acc["rms_rel_err"] <= gate
    return checks, {"calls": calls, "ledger_mass_err": max(em or [0.0]),
                    "ledger_momentum_err": max(ep or [0.0]),
                    "dead_mass_per_call": m_dead}


def sink_disc_2d(dev, card):
    """Phase 94: the 2D self-gravitating disc of gravity_disc_2d
    (check.sink_disc_params(DISC_N): 262,376 particles, M4 grad-h,
    energy_eqn, mon97, the quadrupole tree at theta^2 0.1 rebuilt every
    32 steps, float32) with sink creation and plain accretion
    (sink_radius 2, 16 slots), rho_sink from the bootstrap's rho
    (check.sink_disc_sim): setup,
    then SINK_DISC_STEPS timed steps with the counts set to 0 just before
    them; particle-steps/s, sinks formed and their masses, rebuilds and
    replans with their host seconds, launches; the gates of
    _sink_checks (at least SINK_DISC_MIN_SINKS sinks, the tree within
    DISC_ACCURACY_TOL); then K4 (alive mode), K6, K7, K14 and K16-K18
    (2D) against their plain versions at the path's state.  Returns the
    counts, the reports and K4's alive mode in 2D."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_nbody_kernels,
                                         compare_sink_kernels,
                                         compare_tree_kernels,
                                         gravity_accuracy, sim_sink_inputs,
                                         sink_disc_params, sink_disc_sim,
                                         sink_ledger, total_mass)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = sink_disc_params(DISC_N, 2)
    sim, t_setup, boot = sink_disc_sim(params, dev, torch.float32,
                                       block_ic(params))
    mass0 = total_mass(sim)
    sinks0 = int(sim.state.sinks.active.sum())
    rows = sink_ledger(sim)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    replan0 = sim.timing.totals.get("GRID_REPLAN", 0.0)
    names = GRAVITY_2D + SINK_2D
    _ext.reset_launches()
    elapsed = run_timed(sim, SINK_DISC_STEPS)
    launches = {k: _ext.LAUNCHES[k] for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replans = sim._n_grid_overflows - replans0
    s = sim.state
    st = s.sinks
    acc = gravity_accuracy(sim, n_sample=2048)
    checks, ledger = _sink_checks(
        sim, mass0, total_mass(sim), rows, launches,
        {k: 1 for k in SINK_2D}, acc, DISC_ACCURACY_TOL, sinks0,
        SINK_DISC_MIN_SINKS)
    del rows
    checks["launches"] = all(launches[k] >= SINK_DISC_STEPS
                             for k in GRAVITY_2D)
    rep = compare_sink_kernels(sim.kern, sim_sink_inputs(sim), repeats=5)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    m_star = torch.where(st.active, st.m, 0.0)
    rep.update(compare_nbody_kernels(st.r, st.v, m_star, st.h, sim.kern,
                                     repeats=5, which=("direct_softened",)))
    rep = _with_bounds(rep)
    act = st.active
    spec = sim.treespec
    phase("sink_disc_2d", N=s.N, steps=sim.Nsteps,
          timed_steps=SINK_DISC_STEPS, setup_s=t_setup, bootstrap=boot,
          timed_s=elapsed,
          particle_steps_per_s=s.N * SINK_DISC_STEPS / elapsed,
          sinks_formed=int(act.sum()) - sinks0,
          sink_masses=st.m[act].tolist(), dead=int((~s.alive).sum()),
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=sim.timing.totals.get("TREE_REBUILD", 0.0)
          - rebuild0, replans_in_window=replans,
          replan_host_s=sim.timing.totals.get("GRID_REPLAN", 0.0) - replan0,
          G_pad=spec.n_leaves, near_cap=spec.near_cap,
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, ledger=ledger, accuracy=acc,
          accuracy_gate=DISC_ACCURACY_TOL, checks=checks, kernels=rep,
          card=card, peak_mem_gb=peak_gb,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("sink_disc_2d", checks, rep)
    k4 = rep["tree_gather_2d"]
    alive_mode = {"path": "sink_disc_2d",
                  "launches": launches["tree_gather_2d"],
                  "dead": k4["dead"], "max_abs_err": k4["max_abs_err"],
                  "ms": k4["ms"], "plain_ms": k4["plain_ms"]}
    return ({k: launches[k] for k in SINK_2D},
            {k: rep[k] for k in SINK_2D}, alive_mode)


def sink_system_energy(sim) -> float:
    """E of the gas and the sink slots: the gas's kinetic and thermal
    energy and its self-gravity from one full tree pass
    (full_gravity_energy), the active slots' kinetic energy, the star-gas
    potential (K16) and the star-star potential (K14), outside any timed
    window (their launches are not the path's)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.gravity import direct_softened
    from gandalf_tpu_torch.ops.sph_gravity import star_gas_forces

    saved = dict(_ext.LAUNCHES)
    e = full_gravity_energy(sim)
    s = sim.state
    st = s.sinks
    act = st.active
    m_gas = torch.where(s.alive, s.m, 0.0)
    m_star = torch.where(act, st.m, 0.0)
    _, gpot_gas, _, _ = star_gas_forces(sim.kern, s.r, m_gas, s.h, st.r,
                                        m_star, st.h, act)
    gpot_ss = direct_softened(st.r[act], st.v[act], st.m[act], st.h[act],
                              sim.kern).gpot
    _ext.LAUNCHES.update(saved)
    v2 = torch.sum(st.v[act] * st.v[act], dim=-1)
    return (e + float(torch.sum((0.5 * st.m[act] * v2).double()))
            - float(torch.sum((m_gas * gpot_gas).double()))
            - 0.5 * float(torch.sum((st.m[act] * gpot_ss).double())))


def sink_block_disc_2d(dev, card, variant=None, tag="sink_block_disc_2d"):
    """Phase 95: the same disc with Nlevels 4 (level_diff_max 1) and
    smooth accretion, float32, on the dense tick (the coupled pass of
    every particle each tick, K22, the sinks at dt_base): setup,
    SINK_DISC_BLOCK_WARM warm-up ticks, then SINK_DISC_BLOCK_TICKS timed
    ticks with the counts set to 0 just before them; ticks/s, the levels,
    sinks formed, the spin ledger's z range, the energy of the gas and
    the slots over the window (sink_system_energy), the gates of
    _sink_checks (the tree within DISC_BLOCK_ACCURACY_TOL, K20 twice a
    tick); then K20 (2D) against its plain version at the path's state.
    With `variant` the run takes that smoothing kernel: K2, K3, K7, K14,
    K16 and K20 launch under their family names and never under M4's
    (no_m4_launch), the energy drift is held to
    SINK_DISC_QUINTIC_ENERGY_TOL, and K14 and K16 (2D) are compared
    too.  Returns the sink family's counts and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_nbody_kernels,
                                         compare_sink_kernels,
                                         compare_td_sink_kernels,
                                         family_params, gravity_accuracy,
                                         sim_sink_inputs, sim_smooth_inputs,
                                         sink_disc_params, sink_disc_sim,
                                         sink_ledger, total_mass)

    t_phase = time.perf_counter()
    params = sink_disc_params(DISC_N, 2, nlevels=4, smooth_accretion=1)
    if variant is not None:
        family_params(variant, params)
    sim, t_setup, boot = sink_disc_sim(params, dev, torch.float32,
                                       block_ic(params))
    for _ in range(SINK_DISC_BLOCK_WARM):
        sim.main_loop_step()
    mass0 = total_mass(sim)
    sinks0 = int(sim.state.sinks.active.sum())
    e0 = sink_system_energy(sim)
    rows = sink_ledger(sim)
    m4_names = GRAVITY_2D + ("star_gas_forces_2d", "sink_candidate_2d",
                             "direct_softened_2d", "smooth_accretion_2d",
                             "levelneib_2d")
    # K20's sink update reads no kernel: it counts under its M4 name
    names = tuple(dict.fromkeys(_family_names(m4_names, sim.kern)
                                + ("smooth_accretion_2d",)))
    k14, k16, k20 = _family_names(("direct_softened_2d",
                                   "star_gas_forces_2d",
                                   "smooth_accretion_2d"), sim.kern)
    replans0 = sim._n_grid_overflows
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for _ in range(SINK_DISC_BLOCK_TICKS):
        sim.main_loop_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in names}
    m4_launches = {k: _ext.LAUNCHES[k] for k in m4_names if k not in names}
    s = sim.state
    st = s.sinks
    drift = abs(sink_system_energy(sim) - e0) / abs(e0)
    acc = gravity_accuracy(sim, n_sample=2048)
    per_call = {k16: 1, "sink_candidate_2d": 1, k14: 1, k20: 1}
    per_call["smooth_accretion_2d"] = 1 + (k20 == "smooth_accretion_2d")
    checks, ledger = _sink_checks(
        sim, mass0, total_mass(sim), rows, launches, per_call, acc,
        DISC_BLOCK_ACCURACY_TOL, sinks0, 1)
    del rows
    checks["launches"] = all(
        launches[k] >= SINK_DISC_BLOCK_TICKS
        for k in _family_names(GRAVITY_2D, sim.kern) + ("levelneib_2d",))
    rep = compare_td_sink_kernels(
        sim.kern, smooth_inputs=sim_smooth_inputs(sim), repeats=5)
    if variant is not None:
        checks["no_m4_launch"] = not any(m4_launches.values())
        checks["energy_drift"] = drift <= SINK_DISC_QUINTIC_ENERGY_TOL
        rep.update(compare_sink_kernels(sim.kern, sim_sink_inputs(sim),
                                        repeats=5,
                                        which=("star_gas_forces",)))
        m_star = torch.where(st.active, st.m, 0.0)
        rep.update(compare_nbody_kernels(st.r, st.v, m_star, st.h, sim.kern,
                                         repeats=5,
                                         which=("direct_softened",)))
    rep = _with_bounds(rep)
    levels = torch.bincount(s.level.cpu()).tolist()
    act = st.active
    alive = s.alive
    m = s.m[alive]
    spin_z = st.angmom[act, 2]
    phase(tag, kernel=sim.kern.variant, N=s.N, ticks=sim.Nsteps,
          timed_ticks=SINK_DISC_BLOCK_TICKS, setup_s=t_setup,
          bootstrap=boot, timed_s=elapsed,
          ticks_per_s=SINK_DISC_BLOCK_TICKS / elapsed,
          alive_updates_per_s=int(alive.sum()) * SINK_DISC_BLOCK_TICKS
          / elapsed, levels=levels,
          level_max=int(sim._blocksched.level_max),
          sinks_active=int(act.sum()), sinks_formed=int(act.sum()) - sinks0,
          sink_masses=st.m[act].tolist(),
          spin_z_range=[float(spin_z.min()), float(spin_z.max())]
          if int(act.sum()) else None,
          partial=int(((m > 0) & (m < 0.99 * m.max())).sum()),
          dead=int((~alive).sum()),
          replans_in_window=sim._n_grid_overflows - replans0,
          launches=launches, ledger=ledger, energy_drift=drift,
          energy_gate=None if variant is None
          else SINK_DISC_QUINTIC_ENERGY_TOL, accuracy=acc,
          accuracy_gate=DISC_BLOCK_ACCURACY_TOL, checks=checks,
          kernels=rep, card=card, seconds=time.perf_counter() - t_phase)
    _raise_failed(tag, checks, rep)
    keep = (k20,) if variant is None else (k14, k16, k20)
    return {k: launches[k] for k in keep}, {k: rep[k] for k in keep}


def binaryacc_2d(dev, card) -> None:
    """Phase 96: the binaryacc IC at ndim 2 (check.binaryacc_params(
    BINARYACC_SIDE): two lattices of 256 x 512 in [-1, 1]^2, periodic,
    262,144 gas, 2 accreting stars, no self-gravity) in float64 (a star
    of 0.4-0.6 takes ~5e-5 a step: float32 rounds its mass and momentum
    at ~3e-8, ~5e-4 of the step's gain, so the ledger's 1e-5 needs
    float64), BINARYACC_STEPS steps with the counts set to 0 just before
    them:
    particle-steps/s, the gas eaten and the stars' masses, alive fields
    finite, rho > 0, the ledger, gas plus star mass conserved, both stars
    active with finite r and v, K1-K3, K14, K16 and K18 (2D) every
    step."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (binaryacc_params, sink_ledger,
                                         total_mass)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t_phase = time.perf_counter()
    sim = GradhSphSimulation(binaryacc_params(BINARYACC_SIDE), device=dev,
                             dtype=torch.float64)
    t0 = time.perf_counter()
    sim.SetupSimulation()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    mass0 = total_mass(sim)
    m_star0 = sim.state.sinks.m.tolist()
    rows = sink_ledger(sim)
    names = ("grid27_bin_2d", "grid27_density_2d", "grid27_forces_2d",
             "star_gas_forces_2d", "accretion_sums_2d", "direct_softened_2d")
    _ext.reset_launches()
    elapsed = run_timed(sim, BINARYACC_STEPS)
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    st = s.sinks
    checks, ledger = _sink_checks(
        sim, mass0, total_mass(sim), rows, launches,
        {"star_gas_forces_2d": 1, "accretion_sums_2d": 1,
         "direct_softened_2d": 1}, None, None, 0, None)
    del rows
    checks["launches"] = all(n >= BINARYACC_STEPS for n in launches.values())
    checks["stars_active_and_finite"] = bool(st.active.all()) \
        and int(st.N) == 2 and bool(torch.isfinite(st.r).all()) \
        and bool(torch.isfinite(st.v).all())
    phase("binaryacc_2d", N=s.N, steps=sim.Nsteps, setup_s=t_setup,
          timed_s=elapsed,
          particle_steps_per_s=s.N * BINARYACC_STEPS / elapsed,
          eaten=int((~s.alive).sum()), star_masses_before=m_star0,
          star_masses=st.m.tolist(), t_code=sim.t, launches=launches,
          ledger=ledger, checks=checks, card=card,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("binaryacc_2d", checks, {})


def sink_dims_parity(dev):
    """Phase 97: float64 on the card against the plain path on the CPU,
    SINK_DIMS_PARITY_STEPS steps (ticks) each of the 2D disc (384
    particles) with creation and plain accretion, the same disc with
    Nlevels 4 and smooth accretion, the 1D rod (64) with creation and
    smooth accretion, then with plain accretion, and binaryacc at 2 x 16
    x 32: every field within PARITY_TOL of its largest value, the
    sinks' r, v, m and angmom too, equal sinks and eaten gas after every
    step, equal levels and tree plans.  The card's 1D runs are the 1D
    sink path: the counts are set to 0 just before each, and K14, K16,
    K17, K20 (the smooth rod) and K18 (the plain rod) in 1D are held
    against their plain versions at their ends.  Returns the 1D counts
    and reports."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (binaryacc_params,
                                         compare_nbody_kernels,
                                         compare_sink_kernels,
                                         compare_td_sink_kernels,
                                         sim_sink_inputs, sim_smooth_inputs,
                                         sink_disc_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    cases = (
        ("disc_2d", lambda: sink_disc_params(400, 2, 0.3,
                                             ntreebuildstep=4)),
        ("disc_block_2d", lambda: sink_disc_params(
            400, 2, 0.3, nlevels=4, smooth_accretion=1, ntreebuildstep=4)),
        ("rod_1d", lambda: sink_disc_params(64, 1, 0.5, smooth_accretion=1,
                                            ntreebuildstep=4)),
        ("rod_1d_plain", lambda: sink_disc_params(64, 1, 0.5,
                                                  ntreebuildstep=4)),
        ("binaryacc_2d", lambda: binaryacc_params(16)),
    )
    launches, rep = {}, {}
    for tag, make in cases:
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = GradhSphSimulation(make(), device=device,
                                     dtype=torch.float64)
            sim.SetupSimulation()
            sims.append(sim)
        one_d = sims[0].ndim == 1
        if one_d:
            _ext.reset_launches()
        same = True
        created = []
        for _ in range(SINK_DIMS_PARITY_STEPS):
            for sim in sims:
                sim.main_loop_step()
            a, b = (x.state for x in sims)
            same &= bool(torch.equal(a.sinks.active.cpu(), b.sinks.active))
            same &= bool(torch.equal(a.alive.cpu(), b.alive))
            same &= bool(torch.equal(a.level.cpu(), b.level))
            same &= sims[0].treespec == sims[1].treespec
            created.append(int(b.sinks.active.sum()))
        torch.cuda.synchronize()
        if one_d:
            names = [f"{k}_1d" for k in (
                "star_gas_forces", "direct_softened", "sink_candidate",
                "smooth_accretion" if tag == "rod_1d" else "accretion_sums")]
            got = {k: _ext.LAUNCHES[k] for k in names}
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "m", "gpot",
                                    "a"))
        for f in ("r", "v", "m", "angmom"):
            x = getattr(sims[0].state.sinks, f).cpu()
            ref = getattr(sims[1].state.sinks, f)
            err, scale = torch.abs(x - ref).max(), torch.abs(ref).max()
            errs[f"sink_{f}"] = float(err / scale if scale > 0 else err)
        plans = [x._n_tree_plans for x in sims]
        phase("sink_dims_parity", case=tag, ndim=sims[1].ndim,
              N=sims[1].state.N, steps=SINK_DIMS_PARITY_STEPS, rel_err=errs,
              max_rel_err=max(errs.values()),
              same_sinks_eaten_levels_plans=same,
              active_slots_per_step=created,
              dead=int((~sims[1].state.alive).sum()), tree_plans=plans)
        if max(errs.values()) > PARITY_TOL or not same \
                or plans[0] != plans[1]:
            raise RuntimeError(f"sink_dims_parity ({tag}): kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same} {plans}")
        if one_d:
            sim = sims[0]
            r = compare_sink_kernels(sim.kern, sim_sink_inputs(sim),
                                     repeats=5)
            if tag == "rod_1d":
                r.update(compare_td_sink_kernels(
                    sim.kern, smooth_inputs=sim_smooth_inputs(sim),
                    repeats=5))
            st = sim.state.sinks
            r.update(compare_nbody_kernels(
                st.r, st.v, torch.where(st.active, st.m, 0.0), st.h,
                sim.kern, repeats=5, which=("direct_softened",)))
            r = _with_bounds(r)
            checks = {"launches": all(n >= SINK_DIMS_PARITY_STEPS
                                      for n in got.values())}
            phase("sink_rod_1d_kernels", case=tag, N=sim.state.N,
                  launches=got, checks=checks, kernels=r)
            _raise_failed("sink_rod_1d_kernels", checks, r)
            for k in names:
                launches.setdefault(k, got[k])
                rep.setdefault(k, r[k])
    phase("sink_dims_parity_done", seconds=time.perf_counter() - t0)
    return launches, rep


# ---------------------------------------------------------------------------
# 98-104: radiation and radiative feedback below 3D, the command line
# ---------------------------------------------------------------------------

def radiation_kernels_dims(dev):
    """Phase 98: K30 and K34-K37 at NDIM 2 and 1 against their plain
    versions on the card (check.compare_radiation_kernels_dims): in
    float64 at the HII disc of 4,096 and the rod of 1,024 particles
    (4,096 packets, K37 also on three sources, K30 at 64 slots) within
    1e-12 with K37's flags equal; then in float32 at full width, the disc
    at 262,144 and the rod at 65,536 particles (K36 with the first
    Monte-Carlo iteration's 8 N packets, K30 at 262,144 and 65,536
    particles and 64 slots), timed beside the bounds (K34's library time:
    index_add_).  Returns the float32 reports keyed by launch name."""
    from gandalf_tpu_torch.check import compare_radiation_kernels_dims

    t0 = time.perf_counter()
    out = {}
    for ndim in (2, 1):
        rep = compare_radiation_kernels_dims(ndim, dev, torch.float64,
                                             n_slots=RAD_DIMS_SLOTS)
        phase("radiation_kernels_dims", ndim=ndim, dtype="torch.float64",
              report=rep)
        require_ok("radiation_kernels_dims", rep)
        flips = {k: r["flips"] for k, r in rep.items() if "flips" in r}
        if any(flips.values()):
            raise RuntimeError(f"radiation_kernels_dims: K37's flags differ "
                               f"in float64: {flips}")
        n = RAD_DIMS_SIZES[ndim]
        rep = _with_bounds(compare_radiation_kernels_dims(
            ndim, dev, torch.float32, n=n, n_packets=None, repeats=5,
            n_slots=RAD_DIMS_SLOTS))
        phase("radiation_kernels_dims", ndim=ndim, N=n,
              dtype="torch.float32", report=rep)
        require_ok("radiation_kernels_dims", rep)
        out.update(rep)
    phase("radiation_kernels_dims_done", seconds=time.perf_counter() - t0)
    return out


def hii_region_2d(dev, card, scheme):
    """Phases 99-101: the HII region in 2D (check.hii_ic's lattice disc
    of 262,144 particles, one star at the origin, the flat stellar table
    at the scheme's check.spitzer_ndot for Rs = 0.35) in float32 under
    `scheme`: setup, then HII_2D_STEPS steps, each with its radiation
    update (the counts set to 0 just before them); the first update's
    front (the 97th percentile of the ionised particles' distance) within
    HII_2D_FRONT_TOL of Rs, for monoionisation (cross-section
    check.SPITZER_MC_ACROSS_ND[2], 10 iterations) the radius of the
    ionised particles' area within HII_2D_MC_RADIUS_TOL of Rs; finite u, 0
    <= ionfrac <= 1, the scheme's 2D kernels every step; the rate and one
    update's device time (CUDA events).  Returns the scheme's 2D
    launches."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (SPITZER_RS, front_radius,
                                         ionised_radius, spitzer_sim)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sim = spitzer_sim(HII_2D_N, scheme, dev, ndim=2)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    names = tuple(f"{k}_2d" for k in RADIATION[scheme]
                  if k != "grid27_bin")
    _ext.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.main_loop_step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    front = front_radius(sim)
    r_ion = ionised_radius(sim)
    for _ in range(HII_2D_STEPS - 1):
        sim.main_loop_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s = sim.state
    saved = s
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sim._radiation_update()
    stop.record()
    torch.cuda.synchronize()
    update_ms = start.elapsed_time(stop)
    sim.state = saved
    alive = s.alive
    if scheme == "monoionisation":
        gate = abs(r_ion / SPITZER_RS - 1.0) <= HII_2D_MC_RADIUS_TOL
    else:
        gate = abs(front - SPITZER_RS) < HII_2D_FRONT_TOL[scheme]
    checks = {
        "front": gate,
        "finite_u": bool(torch.isfinite(s.u[alive]).all()),
        "ionfrac_in_0_1": bool(((s.ionfrac >= 0) & (s.ionfrac <= 1)).all()),
        "some_neutral": bool((s.ionfrac[alive] < 0.5).any()),
        "launches": all(n >= HII_2D_STEPS for n in launches.values()),
    }
    tag = {"ionisation": "hii_region_2d_ionisation",
           "treeray": "hii_region_2d_treeray",
           "monoionisation": "hii_region_2d_mcrt"}[scheme]
    phase(tag, N=s.N, steps=HII_2D_STEPS, setup_s=t_setup,
          first_step_s=first_s, timed_s=elapsed,
          particle_steps_per_s=s.N * HII_2D_STEPS / elapsed,
          update_device_ms=update_ms, Rs=SPITZER_RS, front_radius=front,
          ionised_area_radius=r_ion, ionised=int((s.ionfrac > 0.5).sum()),
          mc_across=getattr(sim, "mc_across", None),
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          t_code=sim.t, dt_code=float(s.dt), launches=launches,
          checks=checks, card=card, seconds=time.perf_counter() - t_phase)
    _raise_failed(tag, checks, {})
    return launches


def radfb_disc_2d(dev, card):
    """Phase 102: sink_disc_2d's disc (check.sink_disc_params(DISC_N, 2):
    262,376 particles, self-gravity, sink creation with rho_sink at
    0.999 of the bootstrap's largest rho) on the radws relaxation with
    radiative feedback (check.radfb_params: sink, ambient and disc heating
    about the first slot, temp_ambient 1, source radii 0.01; press1
    RADFB_DISC_PRESS, temp_au RADFB_DISC_TEMP_AU), float32:
    setup, RADFB_DISC_STEPS timed steps (the counts set to 0 just before
    them; K30 in 2D every step), then T_amb of every particle at the end
    finite and >= T_inf, the alive fields finite, and K30 (2D) against
    its plain version at the path's state.  Returns K30's 2D launches and
    report."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_ambient_kernels,
                                         radfb_params, radws_params,
                                         sink_disc_params, sink_disc_sim)
    from gandalf_tpu_torch.ops.radiative_fb import \
        combined_ambient_temperature

    t_phase = time.perf_counter()
    params = radfb_params(radws_params(sink_disc_params(DISC_N, 2),
                                       press1=RADFB_DISC_PRESS))
    params.set("temp_au", RADFB_DISC_TEMP_AU)
    sim, t_setup, boot = sink_disc_sim(params, dev, torch.float32)
    names = ("ambient_temperature_2d", "radws_eos", "radws_equilibrium")
    _ext.reset_launches()
    elapsed = run_timed(sim, RADFB_DISC_STEPS)
    launches = {k: _ext.LAUNCHES[k] for k in names}
    s, sk = sim.state, sim.state.sinks
    alive = s.alive
    act = sk.active if sim.radfb_sink_on else torch.zeros_like(sk.active)
    rad = sk.h * sim.sink_cfg.sink_radius
    t_amb = combined_ambient_temperature(
        sim.radfb_sink_cfg, sim.radfb_disc_cfg, s.r, sk.r, sk.m, sk.mdot,
        rad, act)
    _ext.reset_launches()
    _ext.LAUNCHES.update(launches)
    t_inf = sim.radfb_sink_cfg.temp_inf
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[alive]).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "ueq",
                                "dt_therm")),
        "t_amb_finite": bool(torch.isfinite(t_amb).all()),
        "t_amb_at_least_t_inf": bool((t_amb >= t_inf).all()),
        "sinks_formed": bool(sk.active.any()),
        "launches": launches["ambient_temperature_2d"] >= RADFB_DISC_STEPS,
    }
    inputs = {"r": s.r, "rs": sk.r, "m": sk.m, "mdot": sk.mdot,
              "rad": rad, "active": sk.active, "cfg": sim.radfb_sink_cfg}
    rep = compare_ambient_kernels(inputs, repeats=5, cases=(
        ("path", int(sim.radfb_sink_on), sim.radfb_disc_cfg),))
    rep = _with_bounds({"ambient_temperature_2d":
                        rep["ambient_temperature_path"]})
    phase("radfb_disc_2d", N=s.N, alive=int(alive.sum()),
          sinks=int(sk.active.sum()), steps=sim.Nsteps,
          timed_steps=RADFB_DISC_STEPS, setup_s=t_setup, bootstrap=boot,
          timed_s=elapsed,
          particle_steps_per_s=s.N * RADFB_DISC_STEPS / elapsed,
          t_inf=t_inf, t_amb_min=float(t_amb.min()),
          t_amb_max=float(t_amb.max()),
          t_amb_median=float(t_amb.median()), launches=launches,
          checks=checks, kernels=rep, card=card,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("radfb_disc_2d", checks, rep)
    return ({"ambient_temperature_2d": launches["ambient_temperature_2d"]},
            rep)


def radiation_dims_parity(dev):
    """Phase 103: float64 on the card against the plain path on the CPU,
    at tests/test_torch_radiation_dims_sim.py's sizes,
    RAD_DIMS_PARITY_STEPS steps each (radiative feedback 4): the HII disc
    (300 particles; 700 for monoionisation, cross-section 50, the draws
    made on the host) under each scheme, the rod (250) under each scheme,
    SM2012 with ionisation on the disc, radiative feedback on the 2D sink
    disc (400) and on the 1D rod with a star (check.radfb_rod: 64).
    ionfrac equal and r, v, u,
    dt within PARITY_TOL of each field's largest value after every step
    (the feedback runs: every field, sinks, eaten gas).  The card's 1D
    runs are the 1D radiation path: the counts are set to 0 just before
    each, and K30 and K34-K37 (1D) are read at their ends.  Returns the 1D
    counts."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (radfb_params, radfb_rod,
                                         radws_params, sink_disc_params,
                                         spitzer_sim)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    cases = [(f"{scheme}_{nd}d", scheme, nd)
             for nd in (2, 1)
             for scheme in ("ionisation", "treeray", "monoionisation")]
    cases.append(("sm2012_ionisation_2d", "ionisation", 2))
    launches, results = {}, {}
    for tag, scheme, nd in cases:
        n = {2: 700 if scheme == "monoionisation" else 300, 1: 250}[nd]
        over = {"sim": "sm2012sph"} if tag.startswith("sm2012") else {}
        if scheme == "monoionisation":
            over.update(Nphotonratio=1.0, Nraditerations=2)
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = spitzer_sim(n, scheme, device, torch.float64, ndim=nd,
                              **over)
            if scheme == "monoionisation":
                sim.mc_across = RAD_PARITY_MC_ACROSS
                sim.mc_draw_fn = _host_draws(device, nd)
            sims.append(sim)
        if nd == 1:
            _ext.reset_launches()
        same_ion = True
        errs = {}
        for _ in range(RAD_DIMS_PARITY_STEPS):
            for sim in sims:
                sim.main_loop_step()
            a, b = (x.state for x in sims)
            same_ion &= bool(torch.equal(a.ionfrac.cpu(), b.ionfrac))
            for f, e in parity_errors(sims, ("r", "v", "u")).items():
                errs[f] = max(errs.get(f, 0.0), e)
            errs["dt"] = max(errs.get("dt", 0.0), abs(float(a.dt)
                                                      - float(b.dt))
                             / abs(float(b.dt)))
        torch.cuda.synchronize()
        if nd == 1:
            for k in RADIATION[scheme]:
                if k != "grid27_bin":
                    launches[f"{k}_1d"] = _ext.LAUNCHES[f"{k}_1d"]
        results[tag] = {"rel_err": errs, "same_ionfrac": same_ion,
                        "ionised": int((sims[1].state.ionfrac > 0.5).sum()),
                        "N": sims[1].state.N}
        if not same_ion or max(errs.values()) > PARITY_TOL:
            phase("radiation_dims_parity", cases=results)
            raise RuntimeError(f"radiation_dims_parity {tag}: the card "
                               f"parts from the plain path: {results[tag]}")
    for tag, nd in (("radfb_sink_disc_2d", 2), ("radfb_star_rod_1d", 1)):
        sims = []
        for device in (dev, torch.device("cpu")):
            if nd == 2:
                params, ic = radfb_params(radws_params(sink_disc_params(
                    400, 2, 0.3, ntreebuildstep=4))), None
            else:
                params, ic = radfb_rod(64)
            sim = GradhSphSimulation(params, device=device,
                                     dtype=torch.float64)
            sim.SetupSimulation(ic)
            sims.append(sim)
        if nd == 1:
            _ext.reset_launches()
        same = True
        for _ in range(4):
            for sim in sims:
                sim.main_loop_step()
            a, b = (x.state for x in sims)
            same &= bool(torch.equal(a.sinks.active.cpu(), b.sinks.active))
            same &= bool(torch.equal(a.alive.cpu(), b.alive))
        torch.cuda.synchronize()
        if nd == 1:
            launches["ambient_temperature_1d"] = \
                _ext.LAUNCHES["ambient_temperature_1d"]
        errs = parity_errors(sims, ("r", "v", "u", "ueq", "h", "rho"))
        results[tag] = {"rel_err": errs, "same_sinks_and_alive": same,
                        "sinks": int(sims[1].state.sinks.active.sum()),
                        "N": sims[1].state.N}
        if not same or max(errs.values()) > PARITY_TOL:
            phase("radiation_dims_parity", cases=results)
            raise RuntimeError(f"radiation_dims_parity {tag}: the card "
                               f"parts from the plain path: {results[tag]}")
    checks = {"launches_1d": all(n >= RAD_DIMS_PARITY_STEPS
                                 for n in launches.values())
              and len(launches) == 5}
    phase("radiation_dims_parity", steps=RAD_DIMS_PARITY_STEPS,
          cases=results, launches_1d=launches, checks=checks,
          seconds=time.perf_counter() - t0)
    _raise_failed("radiation_dims_parity", checks, {})
    return launches


def _snapshot_diffs(a, b):
    """Differences of snapshot `a` from `b`, each relative to b's largest
    value: with the same gas particles (the files drop accreted ones, so
    an accretion that differs leaves them unmatched) every field's
    largest difference; always the stars' r, v and m and the gas's sums
    of m, m u and m v."""
    def rel(x, y):
        return float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))

    out = {"n_gas": [int(a["m"].shape[0]), int(b["m"].shape[0])]}
    if a["m"].shape == b["m"].shape:
        out.update({k: rel(a[k], b[k]) for k in ("r", "v", "rho", "u", "h")})
    out.update({f"star_{k}": rel(a["star"][k], b["star"][k])
                for k in ("r", "v", "m")})
    for name, f in (("mass", lambda d: d["m"].sum()),
                    ("thermal", lambda d: (d["m"] * d["u"]).sum()),
                    ("momentum", lambda d: (d["m"][:, None] * d["v"]).sum(0))):
        out[f"gas_{name}"] = rel(np.atleast_1d(f(a)), np.atleast_1d(f(b)))
    return out


def cli_restart(dev, card) -> None:
    """Phase 104: the command line.  In a temporary directory, write
    check.cli_params(CLI_SIDE) as a parameter file (binaryacc's 2D
    stream of 2 x 64 x 128 = 16,384 particles with its two stars as the
    ionisation scheme's sources, a flat stellar.dat beside it, SEREN
    unformatted snapshots every tend / 4 to CLI_TEND: the column format's
    reader reads no stars back, and the stars are the run's sources) and
    run `python -m gandalf_tpu_torch` on it in a subprocess on the card
    to tend; run it again stopped by Nstepsmax = CLI_STOP_STEPS, then
    restart that with -r.  The restart must start at the stopped run's t
    (the t of the snapshot its run_id.restart names, rel 1e-10) and
    reach tend with finite fields; the differences between the restart's
    final snapshot and the uninterrupted run's are printed
    (_snapshot_diffs)."""
    import os
    import re
    import tempfile

    from gandalf_tpu_torch.check import (cli_params, write_cli_stellar_table,
                                         write_param_file)
    from gandalf_tpu_torch.sim.io import read_seren_unform

    t_phase = time.perf_counter()
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=repo, GANDALF_WRITE_SNAPSHOTS="1")

    def run(workdir, *args):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "gandalf_tpu_torch", *args, "run.dat"],
            cwd=workdir, env=env, capture_output=True, text=True,
            timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"cli_restart: {args} exited "
                               f"{out.returncode}: {out.stderr[-3000:]}")
        return out.stdout, time.perf_counter() - t0

    def pointed(workdir):
        with open(os.path.join(workdir, "HII2D.restart")) as f:
            f.readline()
            return os.path.join(workdir, f.readline().strip())

    with tempfile.TemporaryDirectory() as base:
        dirs = {k: os.path.join(base, k) for k in ("full", "stop")}
        for k, d in dirs.items():
            os.makedirs(d)
            write_param_file(cli_params(
                CLI_SIDE, tend=CLI_TEND,
                nstepsmax=CLI_STOP_STEPS if k == "stop" else 100000),
                os.path.join(d, "run.dat"))
            write_cli_stellar_table(os.path.join(d, "stellar.dat"))
        _, full_s = run(dirs["full"])
        _, stop_s = run(dirs["stop"])
        t_stop, stopped = read_seren_unform(pointed(dirs["stop"]))
        write_param_file(cli_params(CLI_SIDE, tend=CLI_TEND),
                         os.path.join(dirs["stop"], "run.dat"))
        out, restart_s = run(dirs["stop"], "-r")
        m = re.search(r"Restarting from t = (\S+)", out)
        t_restart = float(m.group(1)) if m else math.nan
        t_end, final = read_seren_unform(pointed(dirs["stop"]))
        t_full, ref = read_seren_unform(pointed(dirs["full"]))
        diffs = _snapshot_diffs(final, ref)
        files = sorted(os.listdir(dirs["stop"]))
    checks = {
        "restart_at_stopped_t": abs(t_restart - t_stop)
        <= 1e-10 * abs(t_stop),
        "stopped_before_tend": t_stop < CLI_TEND,
        "reached_tend": abs(t_end - CLI_TEND) <= 1e-6 * CLI_TEND,
        "finite": all(bool(np.isfinite(final[k]).all())
                      for k in ("r", "v", "rho", "u", "h")),
        "stars_kept": final["nstar"] == stopped["nstar"] == 2,
    }
    phase("cli_restart", N=int(ref["m"].shape[0]), tend=CLI_TEND,
          stop_steps=CLI_STOP_STEPS, t_stop=t_stop, t_restart=t_restart,
          t_end=t_end, t_full=t_full, full_s=full_s, stop_s=stop_s,
          restart_s=restart_s, max_rel_diff_to_uninterrupted=diffs,
          files=files, checks=checks, card=card,
          seconds=time.perf_counter() - t_phase)
    _raise_failed("cli_restart", checks, {})


def mfv_family_kernels(dev) -> None:
    """Phase 105: K10, K11 (with extrema), K31 (tvdscalar and
    springel2009), K12 in check.MFV_FAMILY_FLUX_MODES (HLLC, exact, RK2,
    the cell alphas, zeroslope) and its block mode, K7's MFV mode (3D,
    not the gaussian: F23) and the block pass's K22, K32, K33 with each
    of MFV_FAMILY_VARIANTS at ndim 1-3 against their plain versions on
    the card (check.compare_mfv_family_kernels), in float64 (within
    check.TOL_F64) and float32; the tabulated kernels' reports count the
    pairs near a table point."""
    from gandalf_tpu_torch.check import compare_mfv_family_kernels

    t0 = time.perf_counter()
    n_cases = 0
    for variant in MFV_FAMILY_VARIANTS:
        for ndim in (1, 2, 3):
            for dtype in (torch.float64, torch.float32):
                t1 = time.perf_counter()
                rep = compare_mfv_family_kernels(variant, ndim, dev, dtype)
                torch.cuda.synchronize()
                for r in rep.values():
                    r.pop("work", None)
                phase("mfv_family_kernels", variant=variant, ndim=ndim,
                      dtype=str(dtype), report=rep,
                      seconds=time.perf_counter() - t1)
                require_ok("mfv_family_kernels", rep)
                n_cases += 1
    phase("mfv_family_kernels_done", cases=n_cases,
          seconds=time.perf_counter() - t0)


def mfv_family_parity(dev) -> None:
    """Phase 106: float64 on the card against the plain path on the CPU,
    with equal grid and tree plans: FAMILY_PARITY_STEPS steps of
    mfv_box at FAMILY_PARITY_N^3 (jittered) with each of
    MFV_FAMILY_VARIANTS (the tree but with the gaussian), then
    FAMILY_BLOCK_TICKS ticks of the 2D box (16^2 + 16^2, jittered,
    Nlevels 3) with the tabulated M4 (levels equal) and
    FAMILY_PARITY_STEPS steps of the Sod tube (128 + 32) under mfvrk
    with the exact solver and the quintic; every field within
    PARITY_TOL."""
    from gandalf_tpu_torch.check import (family_params, jittered_box_ic,
                                         jittered_lattice_ic,
                                         mfv_khi_params, mfv_params,
                                         mfv_sod_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    runs = []
    for v in MFV_FAMILY_VARIANTS:
        p = family_params(v, mfv_params(
            FAMILY_PARITY_N, self_gravity=int(not v.startswith("gaussian"))))
        runs.append((f"box_{v}", p, jittered_box_ic(p, FAMILY_PARITY_N),
                     FAMILY_PARITY_STEPS))
    khi = family_params("m4_tab", mfv_khi_params(16, Nlevels=3))
    runs.append(("khi_block_m4_tab", khi, jittered_lattice_ic(khi),
                 FAMILY_BLOCK_TICKS))
    runs.append(("tube_mfvrk_exact_quintic", family_params(
        "quintic", mfv_sod_params(128, 32, sim="mfvrk",
                                  riemann_solver="exact")), None,
        FAMILY_PARITY_STEPS))
    for tag, params, ic, steps in runs:
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = SimulationBase.factory(params.copy(), device,
                                         torch.float64)
            sim.SetupSimulation(None if ic is None else dict(ic))
            for _ in range(steps):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        fields = ("r", "v", "u", "m", "h", "rho", "Qcons0") + (
            ("a", "gpot") if sims[1].self_gravity else ())
        errs = parity_errors(sims, fields)
        same = {"grid": sims[0].gridspec == sims[1].gridspec,
                "tree": sims[0].treespec == sims[1].treespec,
                "plans": ((sims[0]._n_tree_plans, sims[0]._n_grid_overflows)
                          == (sims[1]._n_tree_plans,
                              sims[1]._n_grid_overflows))}
        if sims[1].use_block:
            same["levels"] = bool(torch.equal(sims[0].state.level.cpu(),
                                              sims[1].state.level))
        phase("mfv_family_parity", run=tag, N=sims[1].state.N,
              steps=sims[1].Nsteps, kernel=sims[1].kern.variant,
              rel_err=errs, same=same)
        if max(errs.values()) > PARITY_TOL or not all(same.values()):
            raise RuntimeError(f"mfv_family_parity {tag}: kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same}")
    phase("mfv_family_parity_done", seconds=time.perf_counter() - t0)


def mfv_quintic_box(dev, card):
    """Phase 107: mfv_box at 64^3 (262,144 particles, float32, the
    quadrupole tree) with the quintic: K1, K4-K6, K7's MFV mode and
    K10-K12 with the quintic every step, _mfv_box_variant's run and
    gates (the energy drift within MFV_ENERGY_DRIFT_TOL, as
    mfv_main_path)."""
    return _mfv_box_variant(dev, card, "mfv_quintic_box", kernel="quintic")


def mfv_family_block(dev, card):
    """Phase 108: mfv_block_sphere's run (258,135 particles, 32 ticks)
    with MFV_FAMILY_SPHERE_VARIANT (K12's block mode, K7's MFV mode, K10
    and K11 with the tabulated quintic; K22, K32, K33; the energy within
    MFV_FAMILY_SPHERE_ENERGY_TOL, fault F24), then mfv_khi's
    first run (524,288 particles, HLLC, the Gizmo limiter, a global dt,
    no gravity) with MFV_FAMILY_KHI_VARIANT, its energy within
    MFV_KHI_ENERGY_TOL, and K31 (tvdscalar) with that variant timed at
    its state."""
    launches, rep = mfv_block_sphere(
        dev, card, MFV_FAMILY_SPHERE_VARIANT, "mfv_family_sphere",
        energy_gate=MFV_FAMILY_SPHERE_ENERGY_TOL)
    counts, r = _mfv_khi_run(dev, card, MFV_KHI_STEPS[0], "mfv_family_khi",
                             sweeps=("tvdscalar",),
                             kernel=MFV_FAMILY_KHI_VARIANT)
    _first_counts(launches, rep, counts, r)
    return launches, rep


# ---------------------------------------------------------------------------
# 109-112. the kernel family in cd2010, dust and SM2012 (K21, K23-K26)
# ---------------------------------------------------------------------------

def grid_family_kernels(dev) -> None:
    """Phase 109: K21, K23 (each drag law two-fluid, and test-particle),
    K24, K25 and K26 with each of GRID_FAMILY_VARIANTS at ndim 1-3
    against their plain versions on the card
    (check.compare_grid_family_kernels: K21 at a cd2010 run's state, K23
    to K26 on synthetic inputs), float64 within check.TOL_F64_FAMILY
    (1e-12) and float32 within the kernels' own tolerances; the
    tabulated kernels' reports count the pairs near a table point."""
    from gandalf_tpu_torch.check import compare_grid_family_kernels

    t0 = time.perf_counter()
    n_cases = 0
    for variant in GRID_FAMILY_VARIANTS:
        for ndim in (1, 2, 3):
            for dtype in (torch.float64, torch.float32):
                t1 = time.perf_counter()
                rep = compare_grid_family_kernels(variant, ndim, dev, dtype)
                for r in rep.values():
                    r.pop("work", None)
                phase("grid_family_kernels", variant=variant, ndim=ndim,
                      dtype=str(dtype), report=rep,
                      seconds=time.perf_counter() - t1)
                require_ok("grid_family_kernels", rep)
                n_cases += 1
    phase("grid_family_kernels_done", cases=n_cases,
          seconds=time.perf_counter() - t0)


def grid_family_parity(dev) -> None:
    """Phase 110: float64 on the card against the plain path on the CPU,
    with equal grid and tree plans: GRID_FAMILY_PARITY_STEPS steps of
    sod_td_avisc's cd2010 Sod tube with the quintic, the 1D dusty box
    (dustybox_params(32, 1)) with each of GRID_FAMILY_DUSTYBOX_VARIANTS
    under a global dt and under Nlevels 3 (the dense dust tick, equal
    levels), GRID_FAMILY_DUSTYBOX_STEPS steps or ticks each, the SM2012
    Sod tube (256 + 64) with the tabulated M4 and the SM2012 8^3 box
    with self-gravity and the quintic (tree rebuilt every 2 steps); every
    field within PARITY_TOL."""
    from gandalf_tpu_torch.check import (dustybox_params, family_params,
                                         jittered_box_ic, slice_params,
                                         sm2012_params, sod_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()
    n1, n2, tend = TD_SOD
    cd = family_params("quintic", sod_params(n1, n2, tend=tend))
    cd.set("time_dependent_avisc", "cd2010")
    runs = [("sod_cd2010_quintic", cd, None, GRID_FAMILY_PARITY_STEPS)]
    for v in GRID_FAMILY_DUSTYBOX_VARIANTS:
        runs.append((f"dustybox_{v}", family_params(
            v, dustybox_params(32, 1)), None, GRID_FAMILY_DUSTYBOX_STEPS))
        runs.append((f"dustybox_block_{v}", family_params(
            v, dustybox_params(32, 1, Nlevels=3, level_diff_max=1)), None,
            GRID_FAMILY_DUSTYBOX_STEPS))
    runs.append(("sm2012_tube_m4_tab", family_params(
        "m4_tab", sm2012_params(sod_params(256, 64))), None,
        GRID_FAMILY_PARITY_STEPS))
    box = family_params("quintic", sm2012_params(slice_params(
        FAMILY_PARITY_N, self_gravity=1)))
    box.set("ntreebuildstep", 2)
    runs.append(("sm2012_box_quintic", box,
                 jittered_box_ic(box, FAMILY_PARITY_N),
                 GRID_FAMILY_PARITY_STEPS))
    for tag, params, ic, steps in runs:
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = SimulationBase.factory(params.copy(), device,
                                         torch.float64)
            sim.SetupSimulation(None if ic is None else dict(ic))
            for _ in range(steps):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        fields = ("r", "v", "u", "h", "rho") + (
            ("alpha",) if sims[1].td_avisc_type == "cd2010" else ()) + (
            ("gpot",) if sims[1].self_gravity else ())
        errs = parity_errors(sims, fields)
        same = {"grid": sims[0].gridspec == sims[1].gridspec,
                "tree": sims[0].treespec == sims[1].treespec,
                "plans": ((sims[0]._n_tree_plans, sims[0]._n_grid_overflows)
                          == (sims[1]._n_tree_plans,
                              sims[1]._n_grid_overflows))}
        if sims[1].use_block:
            same["levels"] = bool(torch.equal(sims[0].state.level.cpu(),
                                              sims[1].state.level))
        phase("grid_family_parity", run=tag, N=sims[1].state.N,
              steps=sims[1].Nsteps, kernel=sims[1].kern.variant,
              rel_err=errs, same=same)
        if max(errs.values()) > PARITY_TOL or not all(same.values()):
            raise RuntimeError(f"grid_family_parity {tag}: kernel path "
                               f"disagrees with the plain path: {errs} "
                               f"{same}")
    phase("grid_family_parity_done", seconds=time.perf_counter() - t0)


def family_khi_2d(dev, card):
    """Phase 111: khi_main_path's KHI (425,984 particles, float32) at full
    width through SM2012 with FAMILY_KHI_SM2012_VARIANT (khi_sm2012's run
    and gates) and through grad-h cd2010 with FAMILY_KHI_CD2010_VARIANT
    (khi_cd2010's), each 2 warm-up and FAMILY_KHI_STEPS timed steps, each
    family key launched every step and no M4 key; the rates beside the
    M4 runs'.  Returns the launches and reports of K25, K26 and K21 with
    their variants."""
    launches, rep = khi_sm2012(dev, card, FAMILY_KHI_SM2012_VARIANT,
                               FAMILY_KHI_STEPS, "family_khi_sm2012")
    c_launches, c_rep = khi_cd2010(dev, card, FAMILY_KHI_CD2010_VARIANT,
                                   FAMILY_KHI_STEPS, "family_khi_cd2010")
    launches.update(c_launches)
    rep.update(c_rep)
    return launches, rep


def dusty_evrard_tab(dev, card):
    """Phase 112: dusty_evrard (check.dust_params(131072), the full width)
    with DUSTY_EVRARD_TAB_VARIANT, DUSTY_EVRARD_TAB_STEPS timed steps and
    dusty_evrard's gates; K23 and K24 launch under the variant's names
    every step.  Returns their launches and reports."""
    return dusty_evrard(dev, card, DUSTY_EVRARD_TAB_VARIANT,
                        DUSTY_EVRARD_TAB_STEPS, "dusty_evrard_tab")


# ---------------------------------------------------------------------------
# 113-117. the kernel family in sinks, stars and softened N-body (K14,
# K16, K20)
# ---------------------------------------------------------------------------

def sink_family_kernels(dev) -> None:
    """Phase 113: K14 (with and without the jerk), K16 and K20 with each
    of check.SINK_FAMILY_VARIANTS at ndim 1-3 against their plain
    versions on the card (check.compare_sink_family_kernels, at each of
    check.SINK_FAMILY_SIZES, float64 within check.TOL_F64_FAMILY (1e-12)
    and float32 within the kernels' own tolerances; the tables' reports
    count the pairs near a table point); then one timed row per kernel
    and variant: K16 and K20 at the embedded cluster (SINK_CLUSTER,
    float32), K14 at SINK_FAMILY_TIMED_STARS Plummer stars in float64
    (its plain version's time from the one call its comparison makes);
    and the gaussian, direct and tabulated, refused by the three wrappers
    on CUDA tensors, naming fault F23, with no launch counted.  The
    timed rows carry their bounds; the kernels line takes each family
    entry from the comparison at its own path's state instead."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (SINK_FAMILY_SIZES,
                                         SINK_FAMILY_VARIANTS,
                                         compare_nbody_kernels,
                                         compare_sink_family_kernels,
                                         nbody_kernel_inputs,
                                         smooth_accretion_inputs, smooth_args)
    from gandalf_tpu_torch.kernels.smoothing import VARIANTS, kernel_factory
    from gandalf_tpu_torch.ops import gravity, sinks, sph_gravity

    t0 = time.perf_counter()
    n_cases = 0
    for variant in SINK_FAMILY_VARIANTS:
        for ndim in (1, 2, 3):
            for dtype in (torch.float64, torch.float32):
                for n, ns in SINK_FAMILY_SIZES:
                    t1 = time.perf_counter()
                    rep = compare_sink_family_kernels(variant, ndim, dev,
                                                      dtype, n, ns)
                    for r in rep.values():
                        r.pop("work", None)
                    phase("sink_family_kernels", variant=variant, ndim=ndim,
                          dtype=str(dtype), N=n, Ns=ns, report=rep,
                          seconds=time.perf_counter() - t1)
                    require_ok("sink_family_kernels", rep)
                    n_cases += 1
    n, ns = SINK_CLUSTER
    (r, v, m, h), _ = nbody_kernel_inputs(SINK_FAMILY_TIMED_STARS, dev,
                                          torch.float64)
    for variant in SINK_FAMILY_VARIANTS:
        t1 = time.perf_counter()
        rep = compare_sink_family_kernels(
            variant, 3, dev, torch.float32, n, ns, repeats=5,
            which=("star_gas_forces", "smooth_accretion"))
        name, tab = VARIANTS[variant]
        rep.update(compare_nbody_kernels(
            r, v, m, h, kernel_factory(name, 3, tab), repeats=3,
            which=("direct_softened",)))
        rep = _with_bounds(rep)
        for x in rep.values():
            x["library_ms"] = None
        phase("sink_family_kernels", variant=variant, ndim=3,
              timed={"star_gas_forces": [n, ns], "smooth_accretion": [n, ns],
                     "direct_softened": SINK_FAMILY_TIMED_STARS},
              report=rep, seconds=time.perf_counter() - t1)
        require_ok("sink_family_kernels", rep)
    # the gaussian: refused on CUDA tensors before any launch
    before = dict(_ext.LAUNCHES)
    inp = smooth_accretion_inputs(4096, 16, dev, torch.float32)
    refused = {}
    for tab in (0, 1):
        kern = kernel_factory("gaussian", 3, tab)
        st = inp["sinks"]
        calls = {
            "direct_softened": lambda: gravity.direct_softened(
                st.r, st.v, st.m, st.h, kern, True),
            "star_gas_forces": lambda: sph_gravity.star_gas_forces(
                kern, inp["r"], inp["m"], inp["h"], st.r, st.m, st.h,
                st.active),
            "smooth_accretion": lambda: sinks.smooth_accretion_sums(
                *smooth_args(kern, inp))}
        for k, call in calls.items():
            try:
                call()
                refused[f"{k}_{kern.variant}"] = False
            except NotImplementedError as e:
                refused[f"{k}_{kern.variant}"] = "fault F23" in str(e)
    torch.cuda.synchronize()
    no_launch = _ext.LAUNCHES == before
    phase("sink_family_kernels_done", cases=n_cases,
          gaussian_refused=refused, no_launch=no_launch,
          seconds=time.perf_counter() - t0)
    if not (all(refused.values()) and no_launch):
        raise RuntimeError(f"sink_family_kernels: the gaussian was not "
                           f"refused: {refused}, no launch {no_launch}")


def sink_family_parity(dev) -> None:
    """Phase 114: float64 on the card against the plain path on the CPU
    with the family: sink_parity's random Boss-Bodenheimer cloud
    (SINK_PARITY_BB_N, SINK_PARITY_BB_STEPS steps) with the tabulated M4,
    its hybrid Plummer sphere (SINK_PARITY_PLUMMER) with the tabulated
    quintic, the 2D sink disc (SINK_FAMILY_PARITY_DISC particles, Nlevels
    3, smooth accretion, SINK_FAMILY_PARITY_TICKS dense ticks) with the
    quintic, and nbody_parity's softened hermite4 plummer_cluster
    (NBODY_PARITY_N stars, NBODY_PARITY_STEPS steps) with the tabulated
    M4: equal sinks created at equal steps, equal eaten gas, equal tree
    plans and replans (and levels), every field within PARITY_TOL."""
    from gandalf_tpu_torch.check import (bb_params, family_params,
                                         plummer_stars_params,
                                         sink_disc_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    t0 = time.perf_counter()

    def bb(device):
        p = family_params("m4_tab", bb_params(SINK_PARITY_BB_N,
                                              rho_sink=BB_RHO_SINK))
        p.set("particle_distribution", "random")
        p.set("rand_algorithm", "default")
        return SimulationBase.factory(p, device, torch.float64)

    def plummer(device):
        n_gas, n_star = SINK_PARITY_PLUMMER
        p = family_params("quintic_tab", plummer_stars_params(n_gas,
                                                              n_star))
        p.set("sink_particles", 1)
        return SimulationBase.factory(p, device, torch.float64)

    def disc(device):
        p = family_params("quintic", sink_disc_params(
            SINK_FAMILY_PARITY_DISC, 2, nlevels=3, smooth_accretion=1,
            ntreebuildstep=4, tend=1.0))
        return SimulationBase.factory(p, device, torch.float64)

    for tag, make, steps in (
            ("bb_random_m4_tab", bb, SINK_PARITY_BB_STEPS),
            ("hybrid_plummer_quintic_tab", plummer,
             SINK_PARITY_PLUMMER_STEPS),
            ("sink_disc_block_quintic", disc, SINK_FAMILY_PARITY_TICKS)):
        runs = [_sink_run(make, d, steps) for d in (dev, torch.device("cpu"))]
        sims = [r[0] for r in runs]
        torch.cuda.synchronize()
        errs = parity_errors(sims, ("r", "v", "u", "h", "rho", "gpot"))
        for f in ("r", "v", "m", "mdot"):
            x = getattr(sims[0].state.sinks, f).cpu()
            ref = getattr(sims[1].state.sinks, f)
            errs[f"sink_{f}"] = float(torch.abs(x - ref).max()
                                      / torch.abs(ref).max().clamp_min(1e-300))
        same = {"sinks_and_eaten_each_step": all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(runs[0][1], runs[1][1])),
            "plans": ((sims[0]._n_tree_plans, sims[0]._n_grid_overflows)
                      == (sims[1]._n_tree_plans, sims[1]._n_grid_overflows)),
            "grid": sims[0].gridspec == sims[1].gridspec}
        if sims[1].use_block:
            same["levels"] = bool(torch.equal(sims[0].state.level.cpu(),
                                              sims[1].state.level))
        phase("sink_family_parity", run=tag, kernel=sims[1].kern.variant,
              N=sims[1].state.N, steps=steps, rel_err=errs, same=same,
              active_slots_per_step=[int(t[0].sum()) for t in runs[1][1]],
              dead=int((~sims[1].state.alive).sum()))
        if max(errs.values()) > PARITY_TOL or not all(same.values()):
            raise RuntimeError(f"sink_family_parity: kernel path disagrees "
                               f"with the plain path: {tag} {errs} {same}")
    sims = []
    for device in (dev, torch.device("cpu")):
        sim = make_nbody_sim(NBODY_PARITY_N, device, tabulated_kernel=1)
        sim.SetupSimulation()
        for _ in range(NBODY_PARITY_STEPS):
            sim.main_loop_step()
        sims.append(sim)
    torch.cuda.synchronize()
    errs = parity_errors(sims, ("r", "v", "a", "adot", "a2dot", "gpot"))
    errs["dt"] = abs(sims[0]._dt_host - sims[1]._dt_host) / sims[1]._dt_host
    phase("sink_family_parity", run="plummer_cluster_m4_tab",
          kernel=sims[1].kern.variant, N=NBODY_PARITY_N,
          steps=NBODY_PARITY_STEPS, rel_err=errs)
    if max(errs.values()) > PARITY_TOL:
        raise RuntimeError(f"sink_family_parity: kernel path disagrees "
                           f"with the plain path: plummer_cluster {errs}")
    phase("sink_family_parity_done", seconds=time.perf_counter() - t0)


def bb_sink_collapse_tab(dev, card):
    """Phase 115: bb_sink_collapse at full width (BB_N, float32,
    BB_STEPS_TIMED timed steps) with BB_TAB_VARIANT, that phase's gates
    (its comparisons of K4-K7 and K16-K18 at the path's state among them)
    and no_m4_launch: K1-K7, K14, K16, K17 and K18 under the tabulated M4.
    Returns K16's family count and its report at the path's state."""
    launches, rep, _ = bb_sink_collapse(dev, card, BB_TAB_VARIANT,
                                        "bb_sink_collapse_tab")
    return launches, rep


def sink_block_disc_2d_quintic(dev, card):
    """Phase 116: sink_block_disc_2d at full width (262,376 particles, 2D,
    Nlevels 4, smooth accretion, dense ticks, float32) with
    SINK_DISC_QUINTIC_VARIANT: that phase's gates, no_m4_launch and the
    energy drift within SINK_DISC_QUINTIC_ENERGY_TOL (F24); K14, K16 and
    K20 (both launches) at 2D with the quintic.  Returns their counts and
    reports at the path's state."""
    return sink_block_disc_2d(dev, card, SINK_DISC_QUINTIC_VARIANT,
                              "sink_block_disc_2d_quintic")


def plummer_cluster_tab(dev, card):
    """Phase 117: nbody_main_path (65,536 stars, float64, hermite4,
    softened) with PLUMMER_TAB_VARIANT, its drift within
    NBODY_ENERGY_DRIFT_TOL and K14 against its plain version at the
    path's state.  Returns K14's family count and report."""
    return nbody_main_path(dev, card, PLUMMER_TAB_VARIANT,
                           "plummer_cluster_tab")


def dist_kernels(dev) -> None:
    """K1 with zrow_max, K2 and K3 on ghosted slabs (qz 1, and qz 2 from
    a thin-slab plan) and K38 (ring radius 1) against their plain
    versions at the 16^3 box's 4-shard state in float64 (check.
    compare_dist_kernels: K1 exact, the others within TOL_F64)."""
    from gandalf_tpu_torch.check import (compare_dist_kernels, dist_sim,
                                         thin_slab_plan)

    t0 = time.perf_counter()
    sim = dist_sim(DIST_KERNEL_N, DIST_S, dev, torch.float64)
    thin = thin_slab_plan(sim)
    rep = compare_dist_kernels(sim, ring_radius=1)
    rep.update(compare_dist_kernels(sim, plan=thin,
                                    tag=f"_qz{thin.global_spec.qz}"))
    torch.cuda.synchronize()
    phase("dist_kernels", N=sim._n_orig, shards=DIST_S,
          qz=[sim.distplan.global_spec.qz, thin.global_spec.qz],
          dtype="torch.float64", report=rep,
          seconds=time.perf_counter() - t0)
    require_ok("dist_kernels", rep)
    if thin.global_spec.qz < 2 or "let_far_walk" not in rep:
        raise RuntimeError("dist_kernels: the thin-slab plan or the far "
                           "walk is missing")


def dist_parity(dev) -> None:
    """3 float64 steps of the 16^3 box over 4 shards on the card against
    the same shards on the CPU, hydro and LET gravity, the decomposition
    rebuilt after step 2 (equal plans: the same migrations and replans),
    within PARITY_TOL; and the hydro run against one shard on the card at
    the JAX package's gates (rtol 2e-11, atol 1e-12)."""
    from gandalf_tpu_torch.check import dist_box_params, dist_ic, dist_sim
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    t0 = time.perf_counter()
    runs = {}
    for grav, fields in ((0, ("r", "v", "u", "h", "rho")),
                         (1, ("r", "v", "u", "h", "rho", "gpot"))):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim = dist_sim(DIST_PARITY_N, DIST_S, device, torch.float64,
                           self_gravity=grav,
                           ntreebuildstep=DIST_PARITY_NTB)
            for _ in range(DIST_PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        errs = parity_errors(sims, fields)
        counts = [(x.n_migrations, x.n_replans, x._n_grid_overflows)
                  for x in sims]
        runs["gravity" if grav else "hydro"] = {
            "rel_err": errs, "migrations_replans_overflows": counts}
        if max(errs.values()) > PARITY_TOL or counts[0] != counts[1]:
            raise RuntimeError(f"dist_parity: the card's shards disagree "
                               f"with the CPU's: {errs} {counts}")
        if not grav:
            four = sims[0]
    p = dist_box_params(DIST_PARITY_N, 1)
    one = GradhSphSimulation(p, dev, torch.float64)
    one.SetupSimulation(dist_ic(p))
    for _ in range(DIST_PARITY_STEPS):
        one.main_loop_step()
    torch.cuda.synchronize()
    s1, s4 = one._state_to_host(), four._state_to_host()
    o1 = np.lexsort((s1["r"][:, 2], s1["r"][:, 1], s1["r"][:, 0]))
    o4 = np.lexsort((s4["r"][:, 2], s4["r"][:, 1], s4["r"][:, 0]))
    one_vs_four = {}
    for k in ("r", "v", "rho", "u", "h"):
        a, b = s4[k][o4], s1[k][o1]
        one_vs_four[k] = float(np.max(np.abs(a - b)
                                      / (1e-12 + 2e-11 * np.abs(b))))
    phase("dist_parity", N=four._n_orig, shards=DIST_S,
          steps=DIST_PARITY_STEPS, ntreebuildstep=DIST_PARITY_NTB,
          runs=runs, one_vs_four_gate_ratio=one_vs_four,
          seconds=time.perf_counter() - t0)
    if max(one_vs_four.values()) > 1.0:
        raise RuntimeError(f"dist_parity: 4 shards part from one beyond "
                           f"rtol 2e-11, atol 1e-12: {one_vs_four}")


def dist_main_path(dev, card):
    """The self-gravitating 64^3 box over DIST_S shards on the card in
    float32: setup, STEPS_WARM warm-up steps, DIST_STEPS_TIMED timed
    steps with one rebuild cadence, with the rate beside the
    single-device gravity path's, energy and direct-sum gpot gates, the
    launches per step, the bytes handed between shards per step, and the
    four kernels' times beside their plain versions' at the path's
    shapes.  Returns (launches, report)."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_dist_kernels, dist_sim,
                                         gpot_errors)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = dist_sim(N_MAIN, DIST_S, dev, torch.float32, self_gravity=1,
                   ntreebuildstep=DIST_NTB)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, STEPS_WARM)
    e0 = energy(sim.gathered_state(), gravity=True)
    mig0, rep0, ovf0 = (sim.n_migrations, sim.n_replans,
                        sim._n_grid_overflows)
    sim.group.moved.clear()
    _ext.reset_launches()
    elapsed = run_timed(sim, DIST_STEPS_TIMED)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _ext.LAUNCHES[k] for k in DIST}
    moved = {k: v / DIST_STEPS_TIMED for k, v in sim.group.moved.items()}
    s = sim.gathered_state()
    N = sim._n_orig
    live = s.alive
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    gerr = gpot_errors(sim)
    lp = sim.letplan
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)[live]).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho[live] > 0).all()),
        "no_overflow": not sim._overflowed(),
        "far_shards": lp is not None
        and 2 * lp.ring_radius + 1 < DIST_S,
        "launches": all(n >= DIST_S * DIST_STEPS_TIMED
                        for n in launches.values()),
        "one_cadence": sim.n_replans - rep0 >= 1,
        "gpot_median": gerr["median"] < DIST_GPOT_MEDIAN_TOL,
        "gpot_p99": gerr["p99"] < DIST_GPOT_P99_TOL,
        "energy_drift": drift <= DIST_ENERGY_DRIFT_TOL,
    }
    rep = compare_dist_kernels(sim, repeats=5)
    rate = N * DIST_STEPS_TIMED / elapsed
    RATES["dist_gravity"] = rate
    phase("dist_main_path", N=N, shards=DIST_S, cap=sim.distplan.cap,
          ncells=list(sim.gridspec.ncells), qz=sim.gridspec.qz,
          k_cell=sim.gridspec.k_cell, balanced=sim.distplan.balanced,
          ring_radius=lp.ring_radius if lp else None,
          g_loc=lp.g_loc if lp else None,
          remote_frontier=lp.remote_frontier if lp else None,
          steps=sim.Nsteps, timed_steps=DIST_STEPS_TIMED, setup_s=t_setup,
          timed_s=elapsed, particle_steps_per_s=rate,
          single_device_particle_steps_per_s=RATES.get("gravity"),
          launches=launches,
          launches_per_step={k: n / DIST_STEPS_TIMED
                             for k, n in launches.items()},
          halo_bytes_per_step=moved.get("halo", 0.0),
          moved_bytes_per_step=moved,
          migrations=sim.n_migrations - mig0, replans=sim.n_replans - rep0,
          overflow_replans=sim._n_grid_overflows - ovf0,
          energy_drift=drift, gpot_err=gerr,
          gpot_err_single_device=RATES.get("gpot_err"),
          gpot_gates=[DIST_GPOT_MEDIAN_TOL, DIST_GPOT_P99_TOL],
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"dist_main_path checks failed: {failed}")
    return launches, rep


def kernel_line(launches, rep, alive_modes=None) -> dict:
    """The {"kernels": [...]} object: every kernel's source, launches on
    its main path, error, times and bound in the dtype of the report (a
    report without one comes from a float32 path); `alive_modes` maps a
    K4 entry (tree_gather, tree_gather_2d) to its alive mode's figures on
    a sink path."""
    from gandalf_tpu_torch.check import bound

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rep[name]
        dtype = {"torch.float64": torch.float64}.get(r.get("dtype"),
                                                     torch.float32)
        bound_ms, bound_by = bound(r["work"], dtype)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r.get("library_ms")})
        if name in (alive_modes or {}):
            kernels[-1]["alive_mode"] = alive_modes[name]
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    # the package first: without it nothing is printed
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import (compare_active_kernels,
                                         compare_kernels,
                                         compare_tree_kernels,
                                         gpot_errors, gravity_accuracy,
                                         mapping_times)
    from gandalf_tpu_torch.ops.tree import native_planner

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    t0 = time.perf_counter()
    so = _ext.build()
    _ext.lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_planner()  # the C++ tree planner (g++); raises on failure
    # ptxas's report (registers, stack, spills per kernel) is too long
    # for a phase line
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(_ext.ptxas_report())
    # the sources that finished last: all start together, so their wall
    # times are the build's critical path on this machine's cores
    slowest = sorted(_ext.build_times().items(), key=lambda kv: -kv[1])[:8]
    phase("build", seconds=build_s, planner_seconds=time.perf_counter() - t0,
          library=so.name, kernels="K1-K38", sources=list(_ext._UNITS),
          slowest=slowest, ptxas=str(out / "ptxas.txt"))

    # 3-4. kernels against their plain versions at small sizes
    for n_side in (16, 32):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_sim(n_side, dev, dtype)
            sim.SetupSimulation(ic)
            rep = compare_kernels(sim, sim.state)
            torch.cuda.synchronize()
            phase("kernels", n_side=n_side, dtype=str(dtype), report=rep)
            require_ok("kernels", rep)
    for n_side in (16, 32):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_sim(n_side, dev, dtype, self_gravity=1)
            sim.SetupSimulation(ic)
            rep = compare_tree_kernels(sim, sim.state)
            phase("tree_kernels", n_side=n_side, dtype=str(dtype),
                  G=sim.treespec.n_leaves, near_cap=sim.treespec.near_cap,
                  report=rep)
            require_ok("tree_kernels", rep)
    for n_target in ACTIVE_SIZES:
        for dtype in (torch.float64, torch.float32):
            sim = make_block_sim(n_target, dev, dtype)
            sim.SetupSimulation()
            N = sim.state.N
            eighth = np.sort(np.random.default_rng(1).choice(
                N, N // 8, replace=False))
            for subset, idx in (("eighth", eighth), ("all", np.arange(N))):
                rep = compare_active_kernels(
                    sim, sim.state, torch.as_tensor(idx, dtype=torch.int32,
                                                    device=dev))
                phase("active_kernels", N=N, dtype=str(dtype),
                      subset=subset, k_cell=sim.gridspec.k_cell,
                      G=sim.treespec.n_leaves, report=rep)
                require_ok("active_kernels", rep)

    # 5-6. end-to-end parity, kernels on the card against the plain CPU
    # path, without and with self-gravity
    for tag, grav, fields in (
            ("parity", 0, ("r", "v", "u", "h", "rho")),
            ("tree_parity", 1, ("r", "v", "u", "h", "rho", "gpot"))):
        sims = []
        for device in (dev, torch.device("cpu")):
            sim, ic = make_sim(
                16, device, torch.float64, self_gravity=grav,
                ntreebuildstep=GRAVITY_NTB_PARITY if grav else None)
            sim.SetupSimulation(ic)
            for _ in range(PARITY_STEPS):
                sim.main_loop_step()
            sims.append(sim)
        torch.cuda.synchronize()
        errs = parity_errors(sims, fields)
        counts = [(s._n_tree_plans, s._n_grid_overflows) for s in sims]
        phase(tag, n_side=16, steps=PARITY_STEPS, rel_err=errs,
              tree_plans_and_replans=counts)
        if max(errs.values()) > PARITY_TOL or counts[0] != counts[1]:
            raise RuntimeError(f"{tag}: kernel path disagrees with the "
                               f"plain path: {errs} {counts}")
    block_parity(dev)

    # 7. the hydro main path at full size
    sim, ic = make_sim(N_MAIN, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    e0 = energy(sim.state)
    done = 0
    while done < STEPS_WARM:
        done += sim.main_loop_steps(STEPS_WARM - done)
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    done = 0
    while done < STEPS_TIMED:
        done += sim.main_loop_steps(STEPS_TIMED - done)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _ext.LAUNCHES[k] for k in HYDRO}
    s = sim.state
    N = s.N
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ("r", "v", "a", "u", "h", "rho", "dudt"))
    drift = abs(energy(s) - e0) / abs(e0)
    checks = {
        "finite": finite,
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= STEPS_TIMED for n in launches.values()),
        "energy_drift": drift < ENERGY_DRIFT_TOL,
    }
    rep = compare_kernels(sim, s, repeats=5)
    mapping = mapping_times(sim, s)
    RATES["hydro"] = N * STEPS_TIMED / elapsed
    phase("main_path", N=N, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, steps=sim.Nsteps,
          timed_steps=STEPS_TIMED, setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * STEPS_TIMED / elapsed,
          grid_replans=sim._n_grid_overflows, launches=launches,
          energy_drift=drift, checks=checks, kernels=rep,
          slot_mappings=mapping, card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"main path checks failed: {failed}")
    del sim, s

    # 8. the self-gravitating main path at full size
    sim, ic = make_sim(N_MAIN, dev, torch.float32, self_gravity=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run_timed(sim, STEPS_WARM)
    # bench.py's post-warm-up replan at the live timestep, then re-warm
    sim._plan_tree_buckets(sim.state.r.cpu().numpy())
    run_timed(sim, STEPS_WARM)
    e0 = energy(sim.state, gravity=True)
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    rebuild0 = sim.timing.totals.get("TREE_REBUILD", 0.0)
    _ext.reset_launches()
    elapsed = run_timed(sim, GRAVITY_STEPS_TIMED)
    rebuild_s = sim.timing.totals.get("TREE_REBUILD", 0.0) - rebuild0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _ext.LAUNCHES[k] for k in GRAVITY}
    replans = sim._n_grid_overflows - replans0
    s = sim.state
    N = s.N
    drift = abs(energy(s, gravity=True) - e0) / abs(e0)
    acc = gravity_accuracy(sim, n_sample=2048)
    spec = sim.treespec
    # the same walk with the quadrupole terms dropped: the gate must
    # reject it
    mono = gravity_accuracy(sim, n_sample=2048,
                            spec=dataclasses.replace(spec, quadrupole=False))
    checks = {
        "finite": all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("r", "v", "a", "u", "h", "rho", "dudt",
                                "gpot")),
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow) and not acc["overflow"],
        "launches": all(n >= GRAVITY_STEPS_TIMED
                        for n in launches.values()),
        "accuracy": acc["rms_rel_err"] <= ACCURACY_TOL,
        "gate_rejects_monopole": mono["rms_rel_err"] > ACCURACY_TOL,
        "energy_drift": drift <= GRAVITY_ENERGY_DRIFT_TOL,
    }
    rep = compare_kernels(sim, s, repeats=5)
    rep.update(compare_tree_kernels(sim, s, repeats=5))
    RATES["gravity"] = N * GRAVITY_STEPS_TIMED / elapsed
    # the direct-sum gpot error, beside which dist_main_path prints its own
    RATES["gpot_err"] = gpot_errors(sim)
    phase("gravity_main_path", N=N, steps=sim.Nsteps,
          timed_steps=GRAVITY_STEPS_TIMED, setup_s=t_setup,
          timed_s=elapsed,
          particle_steps_per_s=N * GRAVITY_STEPS_TIMED / elapsed,
          rebuilds_in_window=sim._n_tree_plans - plans0 - replans,
          rebuild_host_s=rebuild_s,
          replans_in_window=replans, G_pad=spec.n_leaves, depth=spec.depth,
          near_cap=spec.near_cap, support_cap=spec.support_cap,
          frontier=spec.frontier, frontier_levels=list(spec.frontier_levels),
          ncells=list(sim.gridspec.ncells), k_cell=sim.gridspec.k_cell,
          launches=launches, energy_drift=drift, accuracy=acc,
          monopole_accuracy=mono, accuracy_gate=ACCURACY_TOL,
          gpot_err=RATES["gpot_err"],
          checks=checks, kernels=rep, card=card, peak_mem_gb=peak_gb)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"gravity main path checks failed: {failed}")
    del sim, s

    # 11. the block main path at full size
    b_launches, b_rep = block_main_path(dev, card)
    launches.update(b_launches)
    rep.update(b_rep)

    # 12-14. the meshless finite-volume box
    mfv_kernels(dev)
    mfv_parity(dev)
    m_launches, m_rep = mfv_main_path(dev, card)
    launches.update(m_launches)
    rep.update(m_rep)

    # 15-18. the direct-summation N-body cluster
    nbody_kernels(dev)
    nbody_parity(dev)
    for path in (nbody_main_path, nbody_ts6_path):
        n_launches, n_rep = path(dev, card)
        launches.update(n_launches)
        rep.update(n_rep)

    # 19-23. the walk's options: the Ewald sum, accuracy MACs and fast
    # multipoles
    ewald_kernels(dev)
    tree_option_kernels(dev)
    ewald_parity(dev)
    for path in (ewald_main_path, tree_options_path):
        o_launches, o_rep = path(dev, card)
        launches.update(o_launches)
        rep.update(o_rep)

    # 24-27. sinks: the Boss-Bodenheimer collapse
    sink_kernels(dev)
    sink_parity(dev)
    s_launches, s_rep, alive_mode = bb_sink_collapse(dev, card)
    bb_published(dev, card)
    launches.update(s_launches)
    rep.update(s_rep)

    # 28-34. the 1D and 2D grid path and mirror walls
    dims_kernels(dev)
    mirror_kernels(dev)
    dims_parity(dev)
    for path in (khi_main_path, sod_path, mirror_box):
        d_launches, d_rep = path(dev, card)
        launches.update(d_launches)
        rep.update(d_rep)
        if path is khi_main_path:
            khi_published(dev, card)

    # 35-39. block-stepped star formation and time-dependent viscosity
    rep.update(td_sink_kernels(dev))
    launches.update(block_sink_parity(dev))
    for path in (bb_block_collapse, khi_cd2010, sod_td_avisc):
        t_launches, t_rep = path(dev, card)
        launches.update(t_launches)
        rep.update(t_rep)

    # 40-43. the gas-dust drag
    dust_kernels(dev)
    dust_parity(dev)
    dustybox_path(dev, card)
    d_launches, d_rep = dusty_evrard(dev, card)
    launches.update(d_launches)
    rep.update(d_rep)

    # 44-49. Saitoh & Makino (2012) SPH and the external potentials
    sm2012_kernels(dev)
    for path in (khi_sm2012, sm2012_gravity_box, sm2012_tube):
        m_launches, m_rep = path(dev, card)
        launches.update(m_launches)
        rep.update(m_rep)
    sm2012_parity(dev)
    extpot_box(dev, card)

    # 50-55. RadWS and radiative feedback
    radws_kernels(dev)
    for path in (radws_box, radws_block_box, radfb_cluster, radws_mfv_box):
        out = path(dev, card)
        if out is not None:        # radws_block_box adds no kernel entry
            launches.update(out[0])
            rep.update(out[1])
    radws_parity(dev)

    # 56-62. the quintic, gaussian and tabulated kernels
    kernel_family_kernels(dev)
    family_parity(dev)
    for path in (quintic_gravity_box, tabulated_gravity_box, gaussian_box,
                 gaussian_soundwave, quintic_block):
        f_launches, f_rep = path(dev, card)
        launches.update(f_launches)
        rep.update(f_rep)

    # 63-70. MFV's options and its 1D and 2D grid path
    mfv_option_kernels(dev)
    mfv_dims_parity(dev)
    for path in (mfv_sod_tube, mfv_soundwave, gresho_mfv, mfv_khi,
                 mfvrk_box, mfv_exact_box):
        out = path(dev, card)
        if out is not None:        # the sound wave and Gresho add none
            launches.update(out[0])
            rep.update(out[1])

    # 71-75. block-timestep MFV
    mfv_block_kernels(dev)
    mfv_block_parity(dev)
    for path in (mfv_block_tube, mfv_block_khi, mfv_block_sphere):
        b_launches, b_rep = path(dev, card)
        launches.update(b_launches)
        rep.update(b_rep)

    # 76-80. radiation: ionisation, treeray and Monte-Carlo
    # photoionisation of the Spitzer HII region
    rep.update(radiation_kernels(dev))
    radiation_parity(dev)
    for scheme in ("ionisation", "treeray", "monoionisation"):
        for k, n in _spitzer_path(dev, card, scheme).items():
            if k not in ("grid27_bin",):
                launches[k] = n

    # 81-86. block timesteps on the 1D and 2D grid path
    active_kernels_dims(dev)
    block_dims_parity(dev)
    for path in (block_sod_tube, block_khi_2d):
        b_launches, b_rep = path(dev, card)
        launches.update(b_launches)
        rep.update(b_rep)
    sedov_block_2d(dev, card)
    dustybox_block(dev, card)

    # 87-92. self-gravity below 3D
    tree_kernels_dims(dev)
    for path in (gravity_disc_2d, gravity_block_disc_2d,
                 mfv_gravity_disc_2d):
        g_launches, g_rep = path(dev, card)
        launches.update(g_launches)
        rep.update(g_rep)
    gravity_box_2d(dev, card)
    g_launches, g_rep = gravity_dims_parity(dev)
    launches.update(g_launches)
    rep.update(g_rep)

    # 93-97. sinks below 3D
    sink_kernels_dims(dev)
    s_launches, s_rep, alive_2d = sink_disc_2d(dev, card)
    launches.update(s_launches)
    rep.update(s_rep)
    s_launches, s_rep = sink_block_disc_2d(dev, card)
    launches.update(s_launches)
    rep.update(s_rep)
    binaryacc_2d(dev, card)
    s_launches, s_rep = sink_dims_parity(dev)
    launches.update(s_launches)
    rep.update(s_rep)

    # 98-104. radiation and radiative feedback below 3D, the command line
    rep.update(radiation_kernels_dims(dev))
    for scheme in ("ionisation", "treeray", "monoionisation"):
        launches.update(hii_region_2d(dev, card, scheme))
    r_launches, r_rep = radfb_disc_2d(dev, card)
    launches.update(r_launches)
    rep.update(r_rep)
    launches.update(radiation_dims_parity(dev))
    cli_restart(dev, card)

    # 105-108. the quintic, gaussian and tabulated kernels in MFV
    mfv_family_kernels(dev)
    mfv_family_parity(dev)
    for path in (mfv_quintic_box, mfv_family_block):
        f_launches, f_rep = path(dev, card)
        launches.update(f_launches)
        rep.update(f_rep)

    # 109-112. the kernel family in cd2010, dust and SM2012
    grid_family_kernels(dev)
    grid_family_parity(dev)
    for path in (family_khi_2d, dusty_evrard_tab):
        f_launches, f_rep = path(dev, card)
        launches.update(f_launches)
        rep.update(f_rep)

    # 113-117. the kernel family in sinks, stars and softened N-body
    sink_family_kernels(dev)
    sink_family_parity(dev)
    for path in (bb_sink_collapse_tab, plummer_cluster_tab,
                 sink_block_disc_2d_quintic):
        f_launches, f_rep = path(dev, card)
        launches.update(f_launches)
        rep.update(f_rep)

    # 118-120. the distributed controller over 4 shards on the card
    dist_kernels(dev)
    dist_parity(dev)
    d_launches, d_rep = dist_main_path(dev, card)
    launches.update({k: d_launches[k] for k in d_rep})
    rep.update(d_rep)

    alive_modes = {"tree_gather": alive_mode, "tree_gather_2d": alive_2d}
    print(json.dumps(kernel_line(launches, rep, alive_modes)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
