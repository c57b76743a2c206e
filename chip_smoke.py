#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dftk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. check that a CUDA device exists; print the card's name and power limit
  2. build the hand-written CUDA kernels from dftk_tpu_torch/csrc; print
     ptxas's registers and spills, the DMMA count of the complex128 kernel
     B's SASS and the HMMA count of the bf16 kernels B and A where cuobjdump
     is found
  3. hold each kernel, and the composed local apply, against its plain
     PyTorch version at the Si54 shapes (compact cube 32^3, grid 64^3,
     128 bands, Gamma) in complex128 (bar 1e-11 of max|out|) and complex64
     (bar 1e-5); time kernel, plain version, a one-call library version
     where one exists and a torch.fft local apply with CUDA events, and the
     kernels' device time per call from torch.profiler; kernels A and B
     also in complex64 (their first design), with their bounds
  4. run self_consistent_field (LOBPCG) in float64 on the GPU on the
     bench.py Si54 problem (LDA, HGH lda/si-q4, Ecut 10, Gamma, no
     symmetry) to a density tolerance of 1e-8, and require convergence,
     |E - E_ref| < 1e-7 Ha against the JAX package's CPU float64 energy
     (tests/data/torch_port_si54.json), kernel launches > 0 and no call of a
     plain version on the way
  a. the bf16 ('default') kernels A, B and A+B+A against their plain
     versions at the Si54 shapes: the kernel-vs-plain difference must be at
     least 10x smaller than the plain 'default'-vs-'highest' difference
     (relative Frobenius norms; the max abs errors are printed too); timed
     (one launch with CUDA events, and device time per call from
     torch.profiler), with their bounds, and kernel A beside its one-call
     library version (torch.einsum of operands rounded outside the call),
     held to the plain version by the same rule
  b. the compact-cube-resident Chebyshev filter chain of bench.py:160-192
     at Si54, 128 bands, chains of 25 and 100 applies, in complex128
     'highest', complex64 'highest' and bf16 'default': us per band-apply
     from the slope, and the kernels' launches of each chain
  c. the split CheFSI SCF (self_consistent_field_split, float64, "mixed"
     filter, degree 10, 2 cycles) on Si54 to a density tolerance of 1e-8:
     |E - E_ref| < 1e-7 Ha, every kernel instantiation of the path
     (complex128 and bf16) launched, no plain version called
  d. Si256 (dftk_tpu_torch.tools.run_si_big 4 4 2 10.0: 576 bands,
     band_chunk 256): 3 iterations of the same SCF with finite energies;
     seconds per iteration, peak device memory; then kernels A (forward
     and backward) and B on one 256-band chunk at the Si256 shapes, each
     instantiation against its plain version with the bars of phases 3
     and a, and the one-call torch.einsum of kernel A forward and of kernel
     B against the plain complex128 version at its bar; ms per launch of
     kernel A forward and kernel B (with its strip width and bound, and for
     bf16 the launches of the three iterations) and of the two einsums
  e. the filter-stage probe kernels (csrc/filter_stages.cu) at the JAX
     probes' shapes (t [64, 32, 2, 32, 128] f32, V 64^3, realified factors
     128 x 64): the copy at 1 and 8 planes per block and every stage set
     (f2, f2_rep, f2_rep_f1, full at 1, 4 and 8 planes per block, full
     bf16, rep, dots) against its plain version (f32 bar 1e-5 of max|out|,
     bf16 by the margin rule of phase a), and the one-call library version
     of the copy and of each f32 stage set (torch.mul; one torch.einsum
     over the factors) at the same bar; then, with the counts set to 0, the
     four probe tools' main() (the path: dftk_tpu_torch.tools.probe_{
     pallas_fixed,kernel_pipe,kernel_variants,kernel_incr}), every
     instantiation launched; kernel, plain, library and bound times, and
     the per-launch cost from the slope between chains of 10 and 100 copies
  f. the planar filter chain (csrc/filter_stages.cu, probe_planar: t [64, 2,
     32, 32, 128] f32, V 64^3, eight factors) in f32 and with bf16 operands,
     and the band-major fully fused chain and its swap-only ablation
     (csrc/fused_micro.cu: 256 bands of [32^3] re/im, V 64^3, F 64 x 128,
     G 128 x 64), at the JAX probes' shapes, against their plain versions
     (f32 1e-5 of max|out| on one application, bf16 by the margin rule of
     phase a, swap-only exactly) and their one-call library versions (one
     torch.einsum, or one torch.add per part) at the same bars; then, with
     the counts set to 0, the two tools' main() (the path:
     dftk_tpu_torch.tools.{probe_kernel_planar,bench_fused_micro}), every
     instantiation launched; kernel, plain, library and bound times
  g. the fused-local-apply op probes (csrc/op_probes.cu) at the JAX tools'
     shapes: the transposes t2d [32, 8192], swap [2048, 64, 2], k_a [2, 32,
     32, 64] and k_b [2, 32, 64, 64] exactly, gemm [4096, 64] @ [64, 128],
     k_c (ar, ai [2, 32, 32, 32], F 64 x 128) and the fused axis chain (xb
     [8, 32, 8192], F 64 x 64, V [4096, 1, 32]) within 1e-5 of max|out|,
     against their plain versions and their one-call library versions (the
     .contiguous() copy of the transposed view, torch.matmul, one
     torch.einsum); then, with the counts set to 0, the two tools' main()
     (the path: dftk_tpu_torch.tools.{probe_pallas_fused,
     probe_pallas_fused2}), every instantiation launched; kernel, plain,
     library and bound times, ms per launch in runs of 100 launches, and
     device time per call from torch.profiler
  h. the Mosaic op probes at the JAX tools' shapes: the eight bodies of
     tools/probe_mosaic_ops.py (three reshape copies and a permute on the
     extended op_transpose, f32, 'default' and bf16-operand dots on op_gemm;
     csrc/op_probes.cu) on the tool's inputs of ones (all exactly) and on
     seeded normal inputs (copies and permute exactly, f32 and bf16-operand
     dots within 1e-5 of max|out|, 'default' by the margin rule of phase a),
     and the eleven R-step bodies of tools/probe_mosaic_speed.py
     (csrc/op_speed.cu: six rep_dots and kern_d1 on op_rep_gemm, kern_tp,
     kern_tp2, kern_tp3 on op_rep_swap, kern_vm on op_rep_vmul) at R = 1, 3
     and 100 (swaps and kern_vm exactly; the dots by the margin rule, the
     'highest' ones against the plain 'default' as the 'default' ones are
     against the plain 'highest'), each against its plain version, and
     their one-call
     library versions where one exists (a copy, torch.matmul, torch.mm with
     f32 output; per step torch.addmm, torch.baddbmm or torch.mul) at the
     same bars (the R-step ones at R = 3, 1e-5); then, with the counts set
     to 0, the two tools' main() (the path:
     dftk_tpu_torch.tools.probe_mosaic_{ops,speed}), every instantiation
     launched; kernel, plain, library and bound times as in phase g, and
     the swaps' shared-memory traffic
  i. forces and stresses on the card: Si54 as in phase 4 with atom 0 moved
     by (0.004, -0.002, 0.001) in reduced coordinates; the LOBPCG SCF in
     float64 to a density tolerance of 1e-10 (kernels launched, no plain
     call, |E - E_ref| < 1e-7 Ha), then compute_forces_cart and
     compute_stresses_cart on the card, held against the JAX package's CPU
     float64 values of the same problem
     (tests/data/torch_port_si54_derivatives.json) at 1e-7 Ha/bohr and
     1e-8 Ha/bohr^3, the forces summing to under 1e-5; then the split
     CheFSI SCF ("mixed" filter) to 1e-8, whose compute_forces_split and
     compute_stresses_split equal the complex path on the same state
     within 1e-11 and the JAX values within 1e-6; each derivative's wall
     time (CUDA-synchronised; a first call and a second) and peak device
     memory beside the card's name and power limit
  j. crystal symmetry under model_DFT's default symmetries, against
     tests/data/torch_port_symmetry.json (the JAX package's CPU float64
     values and the ABINIT golden's numbers): j1 the ABINIT silicon golden
     at Ecut 25 (grid 33, the 4 explicit k-points, 8 bands, LOBPCG to an
     energy tolerance of 1e-9): eigenvalues and energy within 1e-5 of
     ABINIT, the k = 0 triple degeneracy within 1e-7; j2 Si8 conventional
     cubic on MonkhorstPack (4, 4, 4) at Ecut 20 (192 operations, 10
     irreducible k-points, grid 48): k-points, weights, symmetries and FFT
     size equal to the JAX package's, the LOBPCG SCF to 1e-10 within 1e-8
     Ha of its energy, the forces under 1e-8; then with atom 0 moved by
     0.004 (1, 1, 1) (6 operations, 20 k-points): energy within 1e-8 Ha,
     forces within 1e-7 Ha/bohr and stresses within 1e-8 Ha/bohr^3 (both
     cells); j3 bench.py's Si54 with the default symmetries and no
     fft_size (1296 operations, grid 72, the numpy path of symmetry
     detection), the split CheFSI SCF ("mixed" filter, symmetrize=True) to
     1e-8 within 1e-7 Ha of the JAX package's energy, with its gap to the
     symmetry-free E_ref printed; before each run, kernels A and B (and
     the A -> B -> A chain) against their plain versions on one band block
     of that run at its own shapes (complex128 at 1e-11; j3 also bf16 by
     the 10x margin); every run with kernels A and B launched and no plain
     call, its wall time and peak device memory; the host build of the
     symmetrization maps and one symmetrizer application
  k. metals, collinear spin and GGA against tests/data/torch_port_metals.json
     (the JAX package's CPU float64 values, and the ABINIT goldens'): k1 the
     iron LDA golden (teter93, Ecut 15, fft 20, MonkhorstPack (4, 4, 4) +
     1/2, FermiDirac 0.01, moment 4; LOBPCG to 1e-8) within 1e-5 of ABINIT
     with its magnetisation in (2.3, 2.7), and the iron PBE golden (Ecut 20,
     to 1e-12) with its 12 (k, spin) eigenvalue rows matched onto ABINIT's
     within 5e-6; k2 the silicon PBE golden (Ecut 25, grid 33) within 1e-5
     of ABINIT's energy and k = 0 eigenvalues; k3 Al4 under Marzari-
     Vanderbilt smearing (0.01) with LdosMixing, 12 electrons within 1e-8;
     each within 1e-8 Ha of the JAX energy; k4 bcc Fe2 with atom 1 moved,
     PBE, moments (4, 4), MonkhorstPack (3, 3, 3), Ecut 15: the LOBPCG SCF
     to 1e-10 within 1e-8 Ha, its forces within 1e-7 Ha/bohr and stresses
     within 1e-8 Ha/bohr^3 of the JAX values, then the split CheFSI SCF
     ("mixed") whose split adapters equal the complex path on its state
     within 1e-11 and the JAX values within 1e-6; k5 ferromagnetic bcc Fe16
     and Fe54 (moment 4 an atom, PBE, Gamma, Ecut 15, default symmetries):
     the split CheFSI SCF with the "mixed" filter and AdaptiveBands to
     1e-7, converged, 1e-8 on the electron count, every kernel
     instantiation launched, Fe16 within 1e-7 Ha of the JAX energy; Fe54
     from fewer bands than it occupies, so that AdaptiveBands grows the
     block; before
     each run kernels A and B against their plain versions at its shapes
     (bf16 too in k4 and k5), and each run's wall, iterations and peak
     device memory beside the card's name and power limit
  l. UPF pseudopotentials, NLCC and meta-GGA against
     tests/data/torch_port_mgga.json (the JAX package's CPU float64 values
     and DFTK's SCAN silicon golden): l1 the SCAN golden (pbe/si-q4, Ecut
     15, grid 27, the silicon k-set, 8 bands, LOBPCG to an energy
     tolerance of 1e-9) within 5e-5 of DFTK's energy and k = 0 eigenvalues
     and 1e-8 Ha of JAX's; l2 silicon PBE from gth/Si.pbe-hgh.upf (Ecut 7,
     grid 17) within 1e-8 Ha of JAX's and 5e-4 of the HGH run, TPSS and
     r2SCAN within 1e-8 Ha, TB09 in both loops (the split one with
     LOBPCG), the loops within 5e-7 and the eigenvalues within 1e-8 of
     JAX's; l3 SCAN + NLCC diamond (C_m.upf, Ecut 10, grid 18, Gamma), the
     LOBPCG and split SCFs (the "mixed" sphere filter) within 1e-8 Ha,
     then with atom 0 moved the forces within 1e-7 Ha/bohr and stresses
     within 1e-8 Ha/bohr^3 of JAX's and the split adapters within 1e-11
     of the complex path; l4 Si54 SCAN (bench.py's cell with pbe/si-q4,
     Ecut 10, grid 64, compact 32^3): LOBPCG to 1e-8, the split CheFSI SCF
     with the "mixed" sphere filter within 1e-7 Ha of it, the all-bf16
     ("default") filter within 1e-4 Ha per atom of the mixed run (15
     iterations, its residual floor), and phase c's LDA Si54 with the
     compact and the sphere filter (compact_filter=False) in turn, twice
     each, every run within 1e-9 Ha of phase c's energy, and the two
     filters' walls per iteration; before each run kernels A and B
     against their plain versions at its shapes, the meta-GGA runs on the
     band block and on the stacked DivAgrad batch (3 x the block's
     bands), bf16 where the run filters in bf16; every run with the
     kernels launched (bf16 too where it filters in bf16) and no plain
     call, its wall, iterations and peak device memory
  m. the other SCF solvers and the response core, in float64: m1 phase
     4's Si54 by scf_potential_mixing (tol 1e-9, capped at 40 iterations:
     its residual stops falling near 1e-6 in both packages, PERF.md section
     6), newton (tol 1e-10, 2 warm-start SCF iterations) and
     direct_minimization (tol 1e-11, at most 500 iterations), each within
     1e-7 Ha of E_ref (the last two converged); m2 the LOBPCG SCF with
     Chi0Mixing to 1e-8, converged within 1e-7 Ha of E_ref; m3 against
     tests/data/torch_port_response.json (the JAX package's CPU float64
     values): chi0 dV of a smooth dV on aluminium (Ecut 6, kgrid 3^3, no
     symmetry, T 0.01, its own SCF to 1e-11) at Sternheimer tol 1e-11 with
     and without the Schur complement within 1e-8 of max|drho|, its charge
     within 1e-8; the helium polarizability (10 bohr box, Ecut 8) within
     1e-6 relative, and its Dyson solve with inexact GMRES within 1e-7 of
     the exact one; the lowest eigenvalue of the bare Omega of atomic Si2
     (Ecut 5, Gamma) within 1e-5 of its HOMO-LUMO gap; before each run
     kernels A and B against their plain versions at its band block in
     complex128; every run with the kernels launched and no plain call,
     its wall, iterations, peak device memory, Sternheimer solves, CG
     steps and host reads of a residual norm
  n. Gamma-point DFPT phonons and the elastic response, in float64: n1
     silicon at full width (HGH LDA, Ecut 15, kgrid 4^3 with the crystal
     symmetry, unfolded onto its 64 k-points by the entry points): the
     SCF to 1e-12, dynmat_dfpt_gamma (tol 1e-8, Sternheimer tol 1e-11)
     with the acoustic modes under 0.5 cm^-1 and the optical mode
     threefold to 1e-4, elastic_tensor_response with the cubic structure,
     the dynamical matrix against compute_dynmat_finite_diff (delta 1e-3,
     SCFs to 1e-11) within 1e-6 Ha/bohr^2 and its optical frequencies
     within 1e-5 relative, the elastic tensor's columns 0 and 3 against
     elastic_tensor (strain 1e-4) within 1e-4 Ha/bohr^3; n2 magnesium
     hcp's DFPT dynmat (T 0.01, Ecut 5, kgrid 2^3) against its finite
     differences within 5e-4 of max|C| and aluminium fcc's elastic
     response (T 0.01, Ecut 6, kgrid 3^3, fft 15) against its finite
     differences within 1e-5 Ha/bohr^3; n1, n2 and n3 (silicon at Ecut 6,
     kgrid 2^3) against tests/data/torch_port_phonon.json (the JAX
     package's CPU float64 values, each from its own SCF to 1e-12) within
     1e-9 of max|C| (the metals 1e-8); n3 also diamond from the UPF file
     C_m.upf (LDA, Ecut 7, Gamma): its elastic response against
     the JAX package's within 1e-9 of max|C| and its columns 0 and 3
     against elastic_tensor within 1e-4 Ha/bohr^3; before each run
     kernels A and B against their plain versions at its band block in
     complex128; every run with the kernels launched and no plain call,
     its wall, peak device memory, Sternheimer solves, CG steps and host
     reads of a residual norm
  o. phonons at q, the supercell force constants and the split response
     adapters, in float64 (every k+q apply of H and every complex dV_q psi,
     Re and Im, on kernels A -> B -> A): o1 silicon at phase n1's full
     width: phonon_modes_dfpt_q (tol 1e-8, Sternheimer tol 1e-11) at X and
     at (0.25, 0, 0), dynmat_dfpt_q at (-0.25, 0, 0) against the conjugate
     of D(0.25, 0, 0) (time reversal, 1e-7) and at 0 against
     dynmat_dfpt_gamma without the sum rule (1e-9 real, 1e-10 imaginary),
     compute_force_constants of the (2, 1, 1) supercell on kgrid (2, 4, 4)
     (SCFs to 1e-11, delta 2e-2) with phonon_modes_q at X within 1e-5 Ha
     of the DFPT frequencies, and phonon_band_structure finite with the
     acoustic modes under 0.5 cm^-1 at Gamma; o2 magnesium (T 0.01, Ecut
     5, kgrid 2^3, 6 + 4 bands) at X against its IFC route ((2, 1, 1) on
     kgrid (1, 2, 2), 12 + 6 bands) within 2e-5 Ha; o3 against
     tests/data/torch_port_phonon_q.json (the JAX package's CPU float64
     values): silicon at Ecut 4 on kgrid 2^3, D(X) from the port's own SCF
     to 1e-12 within 1e-9 of max|D|, the force constants of
     tests/test_phonon_q.py's si_fc fixture within 1e-6 of max|Phi|, and
     dynmat_ewald_q at X against the (2, 1, 1) supercell's Ewald Hessian
     folded (double backward on the card) within 1e-10; o4 from phase c's
     Si54 split SCF state (its occupied bands): apply_chi0_split_ctx of a
     localized dV and solve_dyson_split (tol 1e-9, Sternheimer 1e-11)
     against the complex apply_chi0 and solve_dyson on the same state
     within 1e-9 of max|drho|, and dynmat_dfpt_gamma_split at
     tests/test_phonon_split.py's sizes (silicon Ecut 5 on kgrid 2^3, and
     aluminium) against dynmat_dfpt_gamma (1e-9 relative, aluminium 1e-8)
     and silicon's against the JAX package's split value (1e-9 relative);
     before each run kernels A and B against their plain versions at its
     band block within 1e-14 of max|out|; every run with the kernels
     launched and no plain call, its wall, peak device memory, Sternheimer
     solves, CG steps and host reads of a residual norm
  p. exact exchange and DFT+U in float64 (every apply of H, and every
     Chebyshev step: with extra terms the filter applies the exact H on the
     sphere, on kernels A -> B -> A; the exchange is torch.fft over cuFFT,
     its ACE compression two GEMMs): p1 Si54 HSE06 at full width (bench.py's
     geometry, pbe/si-q4, Ecut 10, 118 bands, 64^3, no symmetry) through
     self_consistent_field and self_consistent_field_split (CheFSI), both
     with ACE until the energy changes by less than 1e-10 Ha (the exchange
     operator lags a step, so the density residual of the LOBPCG loop's
     simple mixing falls slowly), their energies within 1e-7
     Ha, and at the converged state the ACE exchange energy within 1e-9 Ha
     of the bare one once the shift of ACE's jitter eps (eps sum(w f) / 2,
     1.3e-9 Ha at Si54) is taken off, with one bare exchange apply timed; p2 the exchange
     (HSE06 and bare Coulomb) of seeded orthonormal orbitals on the same
     basis against tests/data/torch_port_exx.json's JAX values (E_x and the
     band diagonal, 1e-10 relative); p3 HSE06 silicon (Ecut 10, Gamma) and
     HF and PBE0 helium (Ecut 15) against the JAX package's energies
     (1e-7 Ha); p4 HF helium on the (2, 1, 1) grid and its doubled cell at
     Gamma in both loops, per cell within 1e-7 Ha and against JAX's; p5
     C2 PBE+U (C_m.upf, kgrid 2^3, the occupation matrix symmetrized) in
     both loops against JAX's total and Hubbard energies (1e-7 Ha) and each
     other; SCFs of p3-p5 to 1e-9 from the JAX runs' seeded orbitals;
     before each run kernels A and B against their plain versions at its
     band block; every run with the kernels launched and no plain call,
     its wall, peak device memory, iterations and ACE builds
  q. the model Hamiltonians' terms in float64, on 3D, 2D (n3 = 1) and 1D
     (n2 = n3 = 1) grids, against tests/data/torch_port_terms.json (the JAX
     package's CPU float64 values): q1 bench.py's Si54 with BlowupCHV, the
     external potential 0.05 sum_a cos(2 pi x_a) and Lennard-Jones between
     the Si atoms: its explicit kinetic, pairwise energy and forces and one
     apply of H to 8 seeded orbitals against JAX (1e-10 relative), the
     LOBPCG and the split SCF ("mixed": under the blow-up its CheFSI takes
     LOBPCG steps, bf16 then exact) to 1e-8 within 1e-7 Ha of each other,
     and the force on atom 0 against a central difference of two SCF
     energies (+-1e-3 bohr, bar 1e-5 Ha/bohr); q2 Fock-Darwin at Ecut 24
     against its exact spectrum (2e-4), total (5e-4), energy bookkeeping
     (1e-10) and L_z = -1 from compute_current (1e-3), and the rotating 2D
     GP by 600 iterations of direct minimization from seeded orbitals
     against JAX (1e-7 Ha; neither run converges in 600), with its Magnetic
     energy below -1e-3 and an in-plane current above 1e-4; q3 anyons at
     Ecut 20 from the winding start within 5e-3 of 4.64955 with
     e(1,1)/(2 pi) in [1.1, 1.3], and the hand operator against
     torch.autograd (1e-12 of max); q4 the 1D GP of
     examples/custom_potential.py (Ecut 500) with its forces and the 3D GP
     by direct minimization against JAX (1e-7 Ha; forces 1e-7 Ha/bohr,
     |F0 + F1| < 1e-5); before each run kernels A and B against their
     plain versions at its band block (bf16 too where the run launches it
     or on the unit-axis grids), and the unit-axis launches timed with
     their bounds; every run with the kernels launched (bf16 too in the
     split run) and no plain call, its wall, iterations and peak device
     memory
  r. what a user does after an SCF, in float64, against
     tests/data/torch_port_post.json: r1 examples/band_structure_dos.py's
     silicon (LDA, Ecut 12, kgrid 4^3, SCF to 1e-10 within 1e-7 Ha of
     JAX), compute_bands(n_bands=8, kline_density=12) along the fcc path
     (its largest residual under 1e-6, its Gamma within 1e-6 Ha of the
     SCF's, its G, X and L within 1e-7 Ha of the JAX package's), the
     valence DOS integrating to 8 within 0.1, the LDOS integrating over
     the cell to the DOS within 1e-10 relative,
     and the PDOS of the PBE UPF twin at Gamma's band edges (bottom s-like,
     top p-like); r2 phase i's displaced Si54 refined from Ecut 10 to 15
     (refine_scfres, refine_forces) against a full Ecut-15 SCF (the refined
     energy's error under a third of the coarse energy's, the refined
     forces' under the coarse forces'); r3 its relaxation by
     optimize_geometry (tol_force 1e-3, 20 L-BFGS iterations): converged,
     the energy fallen, atom 0 back at its site within 1e-3 modulo a common
     translation; r4 phase c's split result and r1's SCF saved and loaded
     (r1's restarted within 3 iterations, 1e-10 Ha of the saved energy),
     the .vts of r1's density, the Wannier90 files of r1's silicon on the
     full grid (4 functions; overlaps at most 1), and the calculator's
     state reuse at Si2; kernels A and B against their plain versions at
     r1's and r2's fine shapes before their runs; every run of r1-r4 with
     the complex128 kernels launched and no plain call, its wall and peak
     device memory; the sections on the port's timer
  5. print the kernels' JSON line (launches from phases c, e, f, g, h, j,
     k, l, m, n, o, p, q and r, times from phases 3, a, e, f, g and h,
     bounds from the shapes; the main path's kernels also with their device
     time and their max_abs_err at each phase-j, phase-k, phase-l and
     (complex128) phase-m, phase-n, phase-o, phase-p, phase-q and phase-r
     run's shapes), then the result line.
This script imports neither jax nor the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_BANDS_KERNEL = 128
E_TOL = 1e-7
BARS = {"complex128": 1e-11, "complex64": 1e-5}
BF16_MARGIN = 10        # kernel-vs-plain at least 10x below default-vs-highest
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FLOP/s of the
# arithmetic each instantiation stands for (f64 tensor cores, f32 outside
# them, bf16 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"complex128": 67e12, "complex64": 67e12, "float32": 67e12,
              "bf16": 989e12}
SOURCES = {
    "pruned_axis_dft": ("dftk_tpu_torch/csrc/pruned_axis_dft.cu",
                        "dftk_tpu/kernels/fused_local.py:138"),
    "local_plane": ("dftk_tpu_torch/csrc/local_plane.cu",
                    "dftk_tpu/kernels/fused_filter.py:190"),
    "pruned_axis_dft[bf16]": ("dftk_tpu_torch/csrc/pruned_axis_dft.cu",
                              "dftk_tpu/kernels/fused_local.py:138"),
    "local_plane[bf16]": ("dftk_tpu_torch/csrc/local_plane.cu",
                          "dftk_tpu/kernels/fused_filter.py:190"),
}
PROBE_SOURCE = "dftk_tpu_torch/csrc/filter_stages.cu"
PROBE_DIMS = (64, 32, 32, 64, 64, 128)        # n3, m1, m2, n1, n2, nbt of the probes
# the JAX probe body each instantiation replaces (PERF.md lists every one)
PROBE_REPLACES = {
    "probe_copy": "tools/probe_pallas_fixed.py:24",
    "probe_stages[f2]": "tools/probe_kernel_incr.py:71",
    "probe_stages[f2_rep]": "tools/probe_kernel_incr.py:83",
    "probe_stages[f2_rep_f1]": "tools/probe_kernel_incr.py:93",
    "probe_stages[full]": "tools/probe_kernel_incr.py:105",
    "probe_stages[rep]": "tools/probe_kernel_variants.py:96",
    "probe_stages[dots]": "tools/probe_kernel_variants.py:84",
    "probe_stages[full][bf16]": "tools/probe_kernel_variants.py:138",
}

# phase f: source and the JAX probe body of each instantiation
FUSED_SOURCES = {
    "probe_planar": (PROBE_SOURCE, "tools/probe_kernel_planar.py:75"),
    "probe_planar[bf16]": (PROBE_SOURCE, "tools/probe_kernel_planar.py:88"),
    "micro_full": ("dftk_tpu_torch/csrc/fused_micro.cu", "tools/bench_fused_micro.py:50"),
    "micro_swaponly": ("dftk_tpu_torch/csrc/fused_micro.cu", "tools/bench_fused_micro.py:71"),
}

# phase g: the JAX probe body of each op-probe instantiation
OP_SOURCE = "dftk_tpu_torch/csrc/op_probes.cu"
OP_REPLACES = {
    "op_transpose[t2d]": "tools/probe_pallas_fused.py:41",
    "op_transpose[swap]": "tools/probe_pallas_fused.py:61",
    "op_gemm[gemm]": "tools/probe_pallas_fused.py:83",
    "op_fused_axis[fused]": "tools/probe_pallas_fused.py:110",
    "op_transpose[k_a]": "tools/probe_pallas_fused2.py:42",
    "op_transpose[k_b]": "tools/probe_pallas_fused2.py:57",
    "op_gemm[k_c]": "tools/probe_pallas_fused2.py:76",
}


# phase h: the Mosaic op probes; each instantiation's JAX body (row 5: the
# try_kernel call of the body, whose pallas_call is at probe_mosaic_ops.py:18;
# row 6: the kernel body run by run(), pallas_call at probe_mosaic_speed.py:27)
SPEED_SOURCE = "dftk_tpu_torch/csrc/op_speed.cu"
MOSAIC_OPS_LINES = (38, 45, 53, 63, 72, 80, 89, 97)
MOSAIC_SPEED_LINES = (48,) * 6 + (76, 89, 96, 104, 114)
MOSAIC_R = (1, 3, 100)          # the R-step kernels are checked at each
A_SI = 5.131570667152971     # the silicon fcc primitive cell's a / 2 (bohr)
# phase j: the bars of the symmetric paths against the ABINIT golden and the
# JAX package's values in tests/data/torch_port_symmetry.json
SYM_ABINIT_TOL, SYM_DEGENERACY_TOL = 1e-5, 1e-7
SI8_DISPLACEMENT, SI8_E_TOL, SI8_ZERO_FORCE_TOL = 0.004, 1e-8, 1e-8
# phase i: atom 0 of Si54 moved in the supercell's reduced coordinates; the
# bars against tests/data/torch_port_si54_derivatives.json (Ha/bohr, Ha/bohr^3)
DISPLACEMENT = (0.004, -0.002, 0.001)
FORCE_TOL, STRESS_TOL = 1e-7, 1e-8
SPLIT_TOL, ADAPTER_TOL, SUM_RULE_TOL = 1e-6, 1e-11, 1e-5
# phase k: metals, collinear spin and GGA; the cells of
# tests/data/make_torch_port_metals.py, whose values (the JAX package's CPU
# float64 ones, and the ABINIT goldens' copied from tests/test_metals_spin.py
# and tests/test_silicon_pbe.py) are in tests/data/torch_port_metals.json
A_FE = 5.42352                # bcc iron, the conventional cube (bohr)
FE_PRIMITIVE = 2.71176 * np.array([[-1, 1, 1], [1, -1, 1], [1, 1, -1]], dtype=float)
AL_LATTICE = np.diag([4 * 7.6324708938577865, 7.6324708938577865, 7.6324708938577865])
AL_POSITIONS = [np.array([0, 0, 0]), np.array([0, 1 / 2, 1 / 2]),
                np.array([1 / 8, 0, 1 / 2]), np.array([1 / 8, 1 / 2, 0])]
AL_SMEARING_WIDTH = 0.01      # Marzari-Vanderbilt width (Ha) of phase k3
FE2_DISPLACEMENT = (0.004, -0.002, 0.001)
METAL_ABINIT_TOL, IRON_EIG_TOL, IRON_MAGN_TOL = 1e-5, 5e-6, 5e-4
METAL_E_TOL, N_ELECTRONS_TOL, FE_SPLIT_E_TOL = 1e-8, 1e-8, 1e-7
# bands to start (each spin row) of Fe16 and Fe54: the JAX Fe16 run occupies
# 98 bands above 1e-6; Fe54 starts short of its ~330, so that AdaptiveBands
# grows the block on the card
FE_SPLIT_N_BANDS = {2: 96, 3: 280}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sass_counts(lib_path, kernel, opcode):
    """{function: count of `opcode` in its SASS} for the functions of the
    built library whose name holds `kernel`, from cuobjdump; {} (with a
    line saying so) where the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("[2] cuobjdump not found", flush=True)
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and any(w.startswith(opcode) for w in line.split()):
            counts[fn] += 1
    return counts


def fft_local_apply(xc, V_full, live, grid_idx, fft_size):
    """The same operator through torch.fft on the full grid (comparison):
    the live compact cells `live` sit at the flat grid points `grid_idx`."""
    import torch
    nk, nb = xc.shape[:2]
    N = int(np.prod(fft_size))
    full = torch.zeros((nk, nb, N), dtype=xc.dtype, device=xc.device)
    full[:, :, grid_idx] = xc.reshape(nk, nb, -1)[:, :, live]
    psir = torch.fft.ifftn(full.reshape((nk, nb) + fft_size), dim=(-3, -2, -1)) * N
    back = torch.fft.fftn(psir * V_full[:, None], dim=(-3, -2, -1)) / N
    out = torch.zeros_like(xc).reshape(nk, nb, -1)
    out[:, :, live] = back.reshape(nk, nb, N)[:, :, grid_idx]
    return out.reshape(xc.shape)


def local_plane_library(t, V, fac):
    """Kernel B's function as one torch.einsum (a closure): t [nk, nb, n3,
    m1, m2] through F2, F1, V [nk, n3, n1, n2], B1 and B2.  V is made
    complex once, outside the call: on the card einsum refuses to mix
    complex and real operands."""
    import torch
    (F1, F2), (B1, B2), Vc = fac.fwd[:2], fac.bwd[:2], V.to(t.dtype)
    return lambda: torch.einsum("kbzxy,yj,xi,kzij,iX,jY->kbzXY", t, F2, F1, Vc, B1, B2)


def kernel_phase(la, basis, device):
    """Phase 3: kernels vs plain versions at the main path's shapes."""
    import torch
    pf = basis.pruned
    m, n = pf.m_shape, basis.fft_size
    print(f"[3] shapes: compact cube m={m}, grid n={n}, bands={N_BANDS_KERNEL}, "
          f"k-points={basis.n_kpoints}", flush=True)
    # compact cells that hold an occupied frequency on every axis (the pad
    # cells of ops/pruned.py do not); inputs are zero elsewhere so that the
    # torch.fft comparison sees the same data
    sels = [np.unique(np.unravel_index(basis.Gidx_np, n)[a]) for a in range(3)]
    live3 = np.zeros(m, dtype=bool)
    live3[:len(sels[0]), :len(sels[1]), :len(sels[2])] = True
    grid = (sels[0][:, None, None] * n[1] + sels[1][None, :, None]) * n[2] \
        + sels[2][None, None, :]
    live = torch.as_tensor(np.flatnonzero(live3), device=device)
    grid_idx = torch.as_tensor(grid.ravel(), device=device)

    rng = np.random.default_rng(20261016)
    shape = (basis.n_kpoints, N_BANDS_KERNEL) + m
    xc_np = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * live3
    V_np = rng.normal(size=(basis.n_kpoints, n[2], n[0], n[1]))
    results = {}
    for dtype in (torch.complex128, torch.complex64):
        tag = str(dtype).split(".")[-1]
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in pf.factors.fwd),
                              bwd=tuple(f.to(dtype) for f in pf.factors.bwd))
        xc = torch.as_tensor(xc_np, device=device).to(dtype)
        V = torch.as_tensor(V_np, device=device).to(rdt)
        t_ref = la.pruned_axis_dft_plain(xc, fac.fwd[2], True).contiguous()
        cases = {
            "pruned_axis_dft": (lambda: la.pruned_axis_dft(xc, fac.fwd[2], True),
                                lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
            "local_plane": (lambda: la.local_plane(t_ref, V, fac),
                            lambda: la.local_plane_plain(t_ref, V, fac)),
            "local_plane[strip=16]": (lambda: la.local_plane(t_ref, V, fac, strip=16),
                                      lambda: la.local_plane_plain(t_ref, V, fac)),
            "local_apply": (lambda: la.local_apply(xc, V, fac),
                            lambda: la.local_apply_plain(xc, V, fac)),
        }
        for name, (kern, plain) in cases.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            print(f"[3] {name} {tag}: max_abs_err={err:.3e} max|out|={scale:.3e} "
                  f"rel={err / scale:.3e} bar={BARS[tag]:.0e}", flush=True)
            check(err <= BARS[tag] * scale, f"{name} {tag} within {BARS[tag]}")
            if tag == "complex128" or name in ("pruned_axis_dft", "local_plane"):
                # complex64: the two kernels' own timings (their first design)
                key = name if tag == "complex128" else f"{name}[complex64]"
                results[key] = dict(max_abs_err=err, ms=cuda_ms(kern),
                                    plain_ms=cuda_ms(plain), device_ms=device_ms(kern))
        # the one PyTorch call that computes each kernel's function
        sfx = "" if tag == "complex128" else "[complex64]"
        results["pruned_axis_dft" + sfx]["library_ms"] = cuda_ms(
            lambda: torch.einsum("kbxyc,cz->kbzxy", xc, fac.fwd[2]))
        lib = local_plane_library(t_ref, V, fac)
        ref = la.local_plane_plain(t_ref, V, fac)
        err = float((lib() - ref).abs().max())
        print(f"[3] local_plane one-call library vs plain {tag}: max_abs_err={err:.3e}",
              flush=True)
        check(err <= BARS[tag] * float(ref.abs().max()), f"local_plane library call {tag}")
        results["local_plane" + sfx]["library_ms"] = cuda_ms(lib)
        # the same operator through torch.fft, as a comparison
        V_full = V.permute(0, 2, 3, 1).contiguous()
        ffted = fft_local_apply(xc, V_full, live, grid_idx, n)
        ref = la.local_apply_plain(xc, V, fac)
        err = float((ffted - ref).abs().max())
        print(f"[3] torch.fft local apply {tag}: max_abs_err vs plain={err:.3e}",
              flush=True)
        check(err <= BARS[tag] * float(ref.abs().max()), f"torch.fft apply {tag}")
        if tag == "complex128":
            results["torch.fft"] = dict(ms=cuda_ms(
                lambda: fft_local_apply(xc, V_full, live, grid_idx, n)))
    x_shape, t_shape = tuple(xc.shape), (basis.n_kpoints, N_BANDS_KERNEL, n[2], m[0], m[1])
    work64 = {"pruned_axis_dft[complex64]": axis_dft_work(x_shape, m[2], n[2], 8),
              "local_plane[complex64]": local_plane_work(t_shape, n[0], n[1], 8)}
    for name, r in results.items():
        line = f"[3] time {name if name in work64 else 'complex128 ' + name}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in r.items() if k != "max_abs_err" and v is not None)
        if name in work64:
            b = bound(work64[name], "complex64")
            line += f"; bound {b[0]:.4f} ms ({b[1]})"
        print(line, flush=True)
    return results, (xc_np, V_np)


def axis_dft_work(x_shape, K, J, esize):
    """(bytes, flops) of one kernel-A call: input and output read and written
    once, the factor once; 8 real flops per complex multiply-add."""
    batch = x_shape[0] * x_shape[1] * math.prod(x_shape[2:]) // K
    return (batch * (K + J) + K * J) * esize, 8 * batch * K * J


def local_plane_work(t_shape, n1, n2, esize):
    """(bytes, flops) of one kernel-B call on t [nk, nb, n3, m1, m2]."""
    nk, nb, n3, m1, m2 = t_shape
    planes = nk * nb * n3
    macs = planes * (m1 * n2 * m2 + n1 * n2 * m1 + m1 * n2 * n1 + m1 * m2 * n2)
    nbytes = (2 * planes * m1 * m2 + 2 * (m1 * n1 + m2 * n2)) * esize \
        + nk * n3 * n1 * n2 * esize // 2
    return nbytes, 8 * macs


def bound(work, kind):
    """(ms, "bytes" | "operations"): the least time of the work on the card."""
    t_bytes = work[0] / PEAK_BYTES * 1e3
    t_ops = work[1] / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_frobenius(a, b):
    import torch
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bf16_phase(la, basis, device, inputs):
    """Phase a: the bf16 instantiations against their plain versions."""
    import torch
    pf = basis.pruned
    xc_np, V_np = inputs
    fac = la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in pf.factors.fwd),
                          bwd=tuple(f.to(torch.complex64) for f in pf.factors.bwd))
    xc = torch.as_tensor(xc_np, device=device).to(torch.complex64)
    V = torch.as_tensor(V_np, device=device).to(torch.float32)
    t = la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default").contiguous()
    cases = {
        "pruned_axis_dft[bf16]": (
            lambda: la.pruned_axis_dft(xc, fac.fwd[2], True, "default"),
            lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default"),
            lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
        "local_plane[bf16]": (
            lambda: la.local_plane(t, V, fac, precision="default"),
            lambda: la.local_plane_plain(t, V, fac, "default"),
            lambda: la.local_plane_plain(t, V, fac)),
        "local_apply[bf16]": (
            lambda: la.local_apply(xc, V, fac, "default"),
            lambda: la.local_apply_plain(xc, V, fac, "default"),
            lambda: la.local_apply_plain(xc, V, fac)),
    }
    # the one PyTorch call that computes kernel A's bf16 function: one einsum
    # of the operands rounded outside the call (no torch product rounds
    # complex64 operands to bf16 inside it), as B complex128's one call
    # takes V made complex outside
    xr, F3r = la.round_bf16(xc), la.round_bf16(fac.fwd[2])
    library = {"pruned_axis_dft[bf16]": lambda: torch.einsum("kbxyc,cz->kbzxy", xr, F3r)}
    x_shape, t_shape = tuple(xc.shape), tuple(t.shape)
    m3, (n1, n2, n3) = x_shape[-1], basis.fft_size
    work = {"pruned_axis_dft[bf16]": axis_dft_work(x_shape, m3, n3, 8),
            "local_plane[bf16]": local_plane_work(t_shape, n1, n2, 8)}
    results = {}
    for name, (kern, plain, highest) in cases.items():
        out, ref, hi = kern(), plain(), highest()
        torch.cuda.synchronize()
        err, rounding = float((out - ref).abs().max()), float((ref - hi).abs().max())
        rel, rel_rounding = rel_frobenius(out, ref), rel_frobenius(ref, hi)
        print(f"[a] {name}: kernel vs plain max_abs_err={err:.3e} rel={rel:.3e}; "
              f"plain default vs highest max_abs={rounding:.3e} rel={rel_rounding:.3e}; "
              f"ratio (rel) {rel_rounding / max(rel, 1e-300):.3g}", flush=True)
        check(rel * BF16_MARGIN <= rel_rounding,
              f"{name}: kernel-vs-plain {BF16_MARGIN}x below default-vs-highest")
        r = results[name] = dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                                 device_ms=device_ms(kern))
        if name in library:
            lib_rel = rel_frobenius(library[name](), ref)
            print(f"[a] {name} one-call library vs plain: rel={lib_rel:.3e}", flush=True)
            check(lib_rel * BF16_MARGIN <= rel_rounding, f"{name} library call vs plain")
            r["library_ms"] = cuda_ms(library[name])
        line = f"[a] time {name}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in r.items() if k != "max_abs_err" and v is not None)
        if name in work:
            b = bound(work[name], "bf16")
            line += f"; bound {b[0]:.4f} ms ({b[1]})"
        print(line, flush=True)
    return results


def filter_chain_phase(dt, la, basis, device, n_short=25, n_long=100):
    """Phase b: compact-resident filter applies, us per band-apply from the
    slope between two chain lengths (bench.py:143-192)."""
    import torch
    from dftk_tpu_torch.ops import engine_split as es
    volume = basis.model.unit_cell_volume
    rho = dt.guess_density(basis)
    rng = np.random.default_rng(7)
    shape = (basis.n_kpoints, N_BANDS_KERNEL, basis.nG_max)
    X_np = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * basis.mask_np[:, None]
    X_np /= np.linalg.norm(X_np, axis=-1, keepdims=True)
    out = {}
    for label, dtype, prec in (("complex128 highest", torch.complex128, "highest"),
                               ("complex64 highest", torch.complex64, "highest"),
                               ("bf16 default", torch.complex128, "default")):
        sd = es.prepare_split_data(basis, dtype)
        V, _, _ = es.total_potential_split(basis.terms, sd, rho.to(sd.basis_data.kin.dtype),
                                        volume)
        enter, leave, apply_c = es.compact_filter_ops(es.make_split_ham(sd, V), volume,
                                                      precision=prec)
        X = torch.as_tensor(X_np, device=device).to(dtype)
        scale = 1.0 / 40      # keeps the powers of H finite in single precision
        la.counts.reset()

        def chain(n):
            x = enter(X).to(apply_c.dtype)
            for _ in range(n):
                x = apply_c(x).mul_(scale)
            return leave(x)

        t_short = cuda_ms(lambda: chain(n_short), reps=3, warmup=1)
        t_long = cuda_ms(lambda: chain(n_long), reps=3, warmup=1)
        per_apply_us = (t_long - t_short) / ((n_long - n_short) * N_BANDS_KERNEL
                                             * basis.n_kpoints) * 1e3
        out[label] = per_apply_us
        print(f"[b] filter chain {label}: {n_short} applies {t_short:.2f} ms, "
              f"{n_long} applies {t_long:.2f} ms, slope {per_apply_us:.3f} us per "
              f"band-apply ({per_apply_us * N_BANDS_KERNEL / 1e3:.3f} ms per "
              f"{N_BANDS_KERNEL}-band apply); launches {dict(la.counts.launches)}",
              flush=True)
    return out


def split_scf_phase(dt, la, basis, E_ref):
    """Phase c: the split CheFSI SCF, float64, mixed filter, on Si54."""
    import torch
    t0 = time.time()

    def show(info):
        if "E" in info:
            print(f"[c] it={info['n_iter']:3d} E={info['E']:.12f} drho={info['drho']:.3e} "
                  f"eps_r={info['eps_r']:.2f} t={time.time() - t0:.1f}s", flush=True)

    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=60, eigensolver="chefsi", chebyshev_degree=10,
        chefsi_cycles=2, is_converged="density", filter_precision="mixed",
        callback=show)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    E = res["energies"]["total"]
    print(f"[c] split SCF converged={res['converged']} n_iter={res['n_iter']} "
          f"wall={wall:.2f} s E={E:.12f} dE={E - E_ref:.3e} launches={launches} "
          f"plain_calls={plain}", flush=True)
    check(res["converged"], "split SCF converged")
    check(np.isfinite(E) and abs(E - E_ref) < E_TOL, f"split SCF |E - E_ref| < {E_TOL}")
    check(tuple(res["rho"].shape) == (1,) + basis.fft_size
          and bool(torch.isfinite(res["rho"]).all()), "finite density of grid shape")
    check(all(v > 0 for v in launches.values()), "every kernel launched in the split SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the split SCF")
    return launches, E, res


def si256_phase(dt, la, device, n_iter=3):
    """Phase d: a few Si256 iterations, and kernel B at the Si256 shapes."""
    import torch
    from dftk_tpu_torch.tools.run_si_big import (BAND_CHUNK, build_basis, n_bands_of,
                                                 scf_options)
    t0 = time.time()
    basis = build_basis((4, 4, 2), 10.0, device)
    natoms = len(basis.model.atoms)
    n_occ, nb = n_bands_of(natoms)
    print(f"[d] Si{natoms}: {basis}, compact {basis.pruned.m_shape}, {nb} bands, "
          f"set up in {time.time() - t0:.1f} s", flush=True)
    stamps = []

    def show(info):
        torch.cuda.synchronize()
        stamps.append(time.time())
        if "E" in info:
            print(f"[d] it={info['n_iter']} E={info['E']:.10f} drho={info['drho']:.3e} "
                  f"t={stamps[-1] - t0:.1f}s", flush=True)

    opts = dict(scf_options({}), maxiter=n_iter)
    la.counts.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field_split(
        basis, n_bands=n_occ, n_extra_bands=nb - n_occ, eigensolver="chefsi",
        band_chunk=BAND_CHUNK, is_converged="density", callback=show, **opts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_it = np.diff([t0] + stamps)
    launches = dict(la.counts.launches)
    print(f"[d] Si{natoms} {res['n_iter']} iterations, s/iteration "
          f"{[round(float(t), 2) for t in per_it]}, peak device memory {peak:.2f} GiB, "
          f"launches={launches}", flush=True)
    check(all(np.isfinite(E) for E, _ in res["history"]), "finite Si256 energies")
    check(all(v > 0 for v in launches.values()), "every kernel launched at Si256")
    check(all(v == 0 for v in la.counts.plain.values()), "no plain version at Si256")

    # kernels A (forward, backward) and B alone at the Si256 shapes, in one
    # band chunk, against their plain versions: complex128 within its bar,
    # bf16 by the margin rule of phase a; kernel B in complex128 takes the
    # strip-mined path
    m1, m2, m3 = basis.pruned.m_shape
    n1, n2, n3 = basis.fft_size
    fac = basis.pruned.factors
    del res
    rng = np.random.default_rng(5)

    def crandn(shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                               device=device)

    x, t = crandn((1, BAND_CHUNK, m1, m2, m3)), crandn((1, BAND_CHUNK, n3, m1, m2))
    V = torch.as_tensor(rng.normal(size=(1, n3, n1, n2)), device=device)
    for tag, prec, dtype in (("complex128", "highest", torch.complex128),
                             ("bf16", "default", torch.complex64)):
        f = la.LocalFactors(fwd=tuple(a.to(dtype) for a in fac.fwd),
                            bwd=tuple(a.to(dtype) for a in fac.bwd))
        xx, tt = x.to(dtype), t.to(dtype)
        VV = V.to(torch.float64 if tag == "complex128" else torch.float32)
        cases = {
            "kernel A forward": (
                xx, lambda p: la.pruned_axis_dft(xx, f.fwd[2], True, p),
                lambda p: la.pruned_axis_dft_plain(xx, f.fwd[2], True, p)),
            "kernel A backward": (
                tt, lambda p: la.pruned_axis_dft(tt, f.bwd[2], False, p),
                lambda p: la.pruned_axis_dft_plain(tt, f.bwd[2], False, p)),
            "kernel B": (
                tt, lambda p: la.local_plane(tt, VV, f, precision=p),
                lambda p: la.local_plane_plain(tt, VV, f, p)),
        }
        # the one PyTorch call that computes kernel A forward and kernel B
        library = {"kernel A forward": lambda: torch.einsum("kbxyc,cz->kbzxy", xx, f.fwd[2]),
                   "kernel B": local_plane_library(tt, VV, f)}
        for name, (inp, kern, plain) in cases.items():
            out, ref = kern(prec), plain(prec)
            torch.cuda.synchronize()
            rel = rel_frobenius(out, ref)
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            line = (f"[d] {name} {tag} at Si{natoms} shapes in {tuple(inp.shape)} -> "
                    f"{tuple(out.shape)}: vs plain max rel {err:.3e}, rel Frobenius {rel:.3e}")
            del out
            if tag == "complex128":
                check(err <= BARS["complex128"], f"Si256 {name} complex128 vs plain")
                if name in library:
                    lib_out = library[name]()
                    lib_err = float((lib_out - ref).abs().max()) / float(ref.abs().max())
                    del lib_out
                    line += f"; one-call library vs plain max rel {lib_err:.3e}"
                    check(lib_err <= BARS["complex128"], f"Si256 {name} library vs plain")
            else:
                rounding = rel_frobenius(ref, plain("highest"))
                line += f"; plain default vs highest rel Frobenius {rounding:.3e}"
                check(rel * BF16_MARGIN <= rounding,
                      f"Si256 {name} bf16: kernel-vs-plain {BF16_MARGIN}x below "
                      f"default-vs-highest")
            del ref
            if name in library:
                ms = cuda_ms(lambda: kern(prec), reps=5, warmup=1)
                work = (axis_dft_work(tuple(xx.shape), m3, n3, xx.element_size())
                        if name == "kernel A forward" else
                        local_plane_work(tuple(tt.shape), n1, n2, tt.element_size()))
                b = bound(work, tag)
                line += f"; {ms:.3f} ms per launch, bound {b[0]:.3f} ms ({b[1]})"
                if name == "kernel B":
                    strip = (la.local_plane_strip(tt, n1, n2) if tag == "complex128" else
                             la.local_plane_strip_bf16(m1, m2, n1, n2))
                    line += f", strip {strip} of {n2}"
                if tag == "bf16":
                    count = "local_plane[bf16]" if name == "kernel B" else "pruned_axis_dft[bf16]"
                    line += f"; {launches[count]} launches of {count} in the {n_iter} iterations"
                if tag == "complex128":
                    line += (f"; one-call library "
                             f"{cuda_ms(library[name], reps=5, warmup=1):.3f} ms")
            print(line, flush=True)


def stage_work(stages, n3, m1, m2, n1, n2, nbt):
    """(bytes, flops) of one probe call on t [n3, m2, 2, m1, nbt] f32
    (stages None: the copy): t read and written once, each factor and the
    part of V that the stage set reads, once."""
    t_elems = n3 * 2 * m2 * m1 * nbt
    if stages is None:
        return 8 * t_elems, t_elems
    if stages == "rep":
        return 8 * t_elems + 4 * n3 * m1 * m2, t_elems
    f1 = stages in ("f2_rep_f1", "full", "dots")
    flops = 2 * n3 * nbt * 8 * m1 * m2 * n2                    # F2f, F2b
    nbytes = 8 * t_elems + 2 * 4 * 4 * n2 * m2
    if f1:
        flops += 2 * n3 * nbt * 8 * n1 * m1 * n2                # F1f, F1b
        nbytes += 2 * 4 * 4 * n1 * m1
    if stages == "full":
        flops += n3 * 2 * n1 * n2 * nbt
        nbytes += 4 * n3 * n1 * n2
    elif stages == "dots":
        flops += n3 * 2 * n1 * n2 * nbt
        nbytes += 4 * n3 * n1
    return nbytes, flops


def stage_library(stages, t, V, F):
    """The one PyTorch call that computes the f32 stage set `stages` on
    (t, V, F), as a closure, or None where there is none.  The repairs are
    index relabelings, so each chain is one einsum over the factors viewed as
    [n, 2, m, 2]; 'rep' is one torch.mul."""
    import torch
    n3, m2, _, m1, nbt = t.shape
    n1, n2 = V.shape[1:]
    if stages == "rep":                 # out[z, p, c, q, b] = t[...] V[z, q, p]
        Vt = V[:, :m1, :m2].transpose(1, 2)[:, :, None, :, None]
        return lambda: torch.mul(t, Vt)
    F2f, F1f, F1b, F2b = F
    f2f, f1f = F2f.view(n2, 2, m2, 2), F1f.view(n1, 2, m1, 2)     # [j,d,p,c], [i,e,q,d]
    f1b, f2b = F1b.view(m1, 2, n1, 2), F2b.view(m2, 2, n2, 2)     # [Q,f,i,e], [P,C,j,f]
    if stages in ("f2", "f2_rep"):      # the two repairs of f2_rep cancel
        return lambda: torch.einsum("zpcqb,jdpc,PCjd->zPCqb", t, f2f, f2b)
    if stages == "f2_rep_f1":
        return lambda: torch.einsum("zpcqb,jdpc,ieqd,Qfie,PCjf->zPCQb",
                                    t, f2f, f1f, f1b, f2b)
    if stages == "full":
        return lambda: torch.einsum("zpcqb,jdpc,ieqd,zij,Qfie,PCjf->zPCQb",
                                    t, f2f, f1f, V, f1b, f2b)
    if stages == "dots" and n2 == 2 * m1:
        # B [2n2, m1] read as [2m1, n2] and D [2m1, n2] as [2n2, m1] are
        # relabelings of (j, d, q) and (Q, f, d, q) where n2 = 2 m1
        return lambda: torch.einsum("zpcqb,jdpc,iej,zi,Qfie,PCQfd->zPCqb", t, f2f,
                                    F1f.view(n1, 2, n2), V[:, :, 0], f1b,
                                    F2b.view(m2, 2, m1, 2, 2))
    return None


def planar_library(t, V, P):
    """The planar chain as one complex64 torch.einsum (a closure) over
    G = C + iS; A and V are made complex outside the call (on the card
    einsum refuses a real V).  The operands are ordered so that a
    left-to-right contraction keeps the intermediates small."""
    import torch
    c2f, s2f, c1f, s1f, c1b, s1b, c2b, s2b = P
    G2f, G1f, G1b, G2b = (torch.complex(c, s) for c, s in
                          ((c2f, s2f), (c1f, s1f), (c1b, s1b), (c2b, s2b)))
    A, Vc = torch.complex(t[:, 0], t[:, 1]), V.to(torch.complex64)
    return lambda: torch.einsum("zpqb,jp,iq,zij,Qi,Pj->zPQb", A, G2f, G1f, Vc, G1b, G2b)


def planar_as_real(out):
    """A complex [n3, m2, m1, nbt] as the planar layout [n3, 2, m2, m1, nbt]."""
    import torch
    return torch.stack((out.real, out.imag), dim=1)


def micro_full_library(xr, xi, V, F, G):
    """kernel_full as one torch.einsum (a closure) over (re, im) stacked
    outside the call and F, G viewed as [2, M, 2, N] and [2, N, 2, M]; its
    result is [2, K, NB, M, M, M], (re, im) stacked.  The einsum contracts
    left to right, in the chain's own order: the path opt_einsum picks sums
    in another order, 1.25e-5 of max|out| from the plain version on the
    card, which is over the 1e-5 bar."""
    import torch
    M, N = xr.shape[-1], F.shape[1] // 2
    x2, f4, g4 = torch.stack((xr, xi)), F.view(2, M, 2, N), G.view(2, N, 2, M)

    def call():
        with torch.backends.opt_einsum.flags(enabled=False):
            return torch.einsum("eztabc,ecfj,fbgk,gahl,zjkl,hlmA,mknB,njoC->oztABC",
                                x2, f4, f4, f4, V, g4, g4, g4)
    return call


def swaponly_library(xr, xi):
    """kernel_swaponly as one torch.add per part: x[..., :1] broadcast (the
    twelve swaps only permute it back) plus x."""
    import torch
    return lambda: (torch.add(xr[..., :1].expand_as(xr), xr),
                    torch.add(xi[..., :1].expand_as(xi), xi))


def micro_work(name, K, NB, M, N):
    """(bytes, flops) of one fused-micro call: xr, xi read and written once;
    micro_full also V, F and G once, and 16 M N (M^2 + M N + N^2) + 2 N^3
    flops per band; swaponly one add per output value."""
    bands, cube = K * NB, M ** 3
    if name == "micro_swaponly":
        return 16 * bands * cube, 2 * bands * cube
    nbytes = 16 * bands * cube + 4 * (K * N ** 3 + 8 * M * N)
    return nbytes, bands * (16 * M * N * (M * M + M * N + N * N) + 2 * N ** 3)


def planar_work(n3, m1, m2, n1, n2, nbt):
    """(bytes, flops) of one planar call: the realified full chain's flops
    (the same real dots), t read and written once, the eight real factors
    and V once."""
    return (8 * n3 * 2 * m2 * m1 * nbt + 16 * (n2 * m2 + n1 * m1) + 4 * n3 * n1 * n2,
            stage_work("full", n3, m1, m2, n1, n2, nbt)[1])


def fused_probe_phase(device):
    """Phase f: the planar chain and the fused-micro kernels at the JAX
    probes' shapes."""
    import torch
    from dftk_tpu_torch.kernels import filter_stages as fs
    from dftk_tpu_torch.kernels import fused_micro as fm
    from dftk_tpu_torch.tools import bench_fused_micro, probe_harness, probe_kernel_planar
    t_phase = time.time()
    t, V, P = probe_harness.make_planar_inputs(4, *PROBE_DIMS, device)
    K, NB, M, N = 1, bench_fused_micro.NB, bench_fused_micro.M, bench_fused_micro.N
    rng = np.random.default_rng(0)
    conv = lambda s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=device)
    xr, xi, Vm = conv((K, NB, M, M, M)), conv((K, NB, M, M, M)), conv((K, N, N, N))
    F, G = conv((2 * M, 2 * N)), conv((2 * N, 2 * M))
    print(f"[f] planar t {tuple(t.shape)} f32, V {tuple(V.shape)}, factors "
          f"{[tuple(f.shape) for f in P]}; micro xr, xi {tuple(xr.shape)}, V "
          f"{tuple(Vm.shape)}, F {tuple(F.shape)}, G {tuple(G.shape)}", flush=True)
    ident = lambda x: x
    lib_planar = planar_library(t, V, P)
    # name: (kernel, plain, as one tensor, kind, library closure and its
    # conversion or None, work)
    cases = {
        "probe_planar": (lambda: fs.probe_planar(t, V, P), lambda: fs.probe_planar_plain(t, V, P),
                         ident, "float32", (lib_planar, planar_as_real),
                         planar_work(*PROBE_DIMS)),
        "probe_planar[bf16]": (lambda: fs.probe_planar(t, V, P, "default"),
                               lambda: fs.probe_planar_plain(t, V, P, "default"), ident,
                               "bf16", None, planar_work(*PROBE_DIMS)),
        "micro_full": (lambda: fm.micro_full(xr, xi, Vm, F, G),
                       lambda: fm.micro_full_plain(xr, xi, Vm, F, G), torch.stack, "float32",
                       (micro_full_library(xr, xi, Vm, F, G), ident),
                       micro_work("micro_full", K, NB, M, N)),
        "micro_swaponly": (lambda: fm.micro_swaponly(xr, xi, N),
                           lambda: fm.micro_swaponly_plain(xr, xi, N), torch.stack,
                           "float32", (swaponly_library(xr, xi), torch.stack),
                           micro_work("micro_swaponly", K, NB, M, N)),
    }
    results = {}
    for name, (kern, plain, one, kind, lib, _) in cases.items():
        out, ref = one(kern()), one(plain())
        torch.cuda.synchronize()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        line = f"[f] {name}: kernel vs plain max_abs_err={err:.3e} max|out|={scale:.3e}"
        bar = 0.0 if name == "micro_swaponly" else 1e-5
        if kind == "bf16":
            hi = fs.probe_planar_plain(t, V, P)
            rel, rounding = rel_frobenius(out, ref), rel_frobenius(ref, hi)
            print(f"{line}; rel Frobenius {rel:.3e} against plain default vs highest "
                  f"{rounding:.3e}", flush=True)
            check(rel * BF16_MARGIN <= rounding, f"{name}: kernel-vs-plain "
                  f"{BF16_MARGIN}x below default-vs-highest")
        else:
            print(f"{line} rel={err / scale:.3e} bar={bar:g}", flush=True)
            check(bool(torch.isfinite(out).all()) and err <= bar * scale,
                  f"{name} within {bar:g} of max|out|")
        if lib is not None:
            lib_err = float((lib[1](lib[0]()) - ref).abs().max())
            print(f"[f] {name}: one-call library vs plain max_abs_err={lib_err:.3e} "
                  f"bar={bar:g}", flush=True)
            check(lib_err <= bar * scale, f"{name}: library call within {bar:g}")
        del out, ref
        results[name] = dict(max_abs_err=err)

    # the path: the two tools, counts from 0
    fs.counts.reset()
    fm.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    probe_kernel_planar.main(device)
    bench_fused_micro.main(device)
    torch.cuda.synchronize()
    launches = {n: fs.counts.launches[n] for n in ("probe_planar", "probe_planar[bf16]")}
    launches.update(fm.counts.launches)
    print(f"[f] the two tools ran in {time.time() - t0:.1f} s, launches={launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()), "every phase-f kernel launched by the tools")

    for name, (kern, plain, _, kind, lib, work) in cases.items():
        r = results[name]
        r["ms"], r["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
        r["bound_ms"], r["bound_by"] = bound(work, kind)
        r["library_ms"] = None if lib is None else cuda_ms(lib[0])
        print(f"[f] time {name}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "max_abs_err"), flush=True)
    print(f"[f] phase f took {time.time() - t_phase:.1f} s", flush=True)
    return results, launches


def k_c_library(ar, ai, F):
    """k_c as one torch.einsum over (re, im) stacked outside the call and
    F viewed as [2, m, 2n]: (closure, conversion of its [..., 2n] result to
    (re, im) stacked, as the plain version's)."""
    import torch
    m, n = ar.shape[-1], F.shape[1] // 2
    x2, f3 = torch.stack((ar, ai)), F.view(2, m, 2 * n)
    return (lambda: torch.einsum("e...k,ekN->...N", x2, f3),
            lambda y: torch.stack((y[..., :n], y[..., n:])))


def fused_library(xb, F, V):
    """f_kernel as one torch.einsum over xb viewed as [nb, m1, R/2, 2], F as
    [2, m1, 2, m1] (once as F, once as F^T) and V as [R/2, m1]:
    (closure, conversion of its [nb, m1, R/2, 2] result to [nb, m1, R]).
    opt_einsum is off so that it contracts left to right, in the chain's own
    order (as in micro_full_library: opt_einsum's path sums a chain einsum
    in another order, which can miss the 1e-5 bar)."""
    import torch
    nb, m1, R = xb.shape
    x4, f4, v2 = xb.view(nb, m1, R // 2, 2), F.view(2, m1, 2, m1), V.view(R // 2, m1)

    def call():
        with torch.backends.opt_einsum.flags(enabled=False):
            return torch.einsum("bmpc,cmek,pk,dnek->bnpd", x4, f4, v2, f4)
    return call, lambda y: y.reshape(nb, m1, R)


def per_launch_ms(fn, n=100):
    """Milliseconds per call of n back-to-back calls of fn() between two
    CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n=20):
    """Device time per call of fn() (every kernel it launches, summed), from
    torch.profiler over n calls; None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def op_probe_phase(device):
    """Phase g: the fused-local-apply op probes at the JAX tools' shapes."""
    import torch
    from dftk_tpu_torch.kernels import op_probes as op
    from dftk_tpu_torch.tools import probe_pallas_fused, probe_pallas_fused2
    t_phase = time.time()
    check(not torch.backends.cuda.matmul.allow_tf32, "plain f32 matmuls without TF32")
    d1, d2 = probe_pallas_fused.make_inputs(device), probe_pallas_fused2.make_inputs(device)
    x, y, A, B, xb, F, V = (d1[k] for k in ("x", "y", "A", "B", "xb", "F", "V"))
    x4, xv, ar, ai, Fc = (d2[k] for k in ("x4", "xb", "ar", "ai", "F"))
    for tool, d in (("probe_pallas_fused", d1), ("probe_pallas_fused2", d2)):
        print(f"[g] {tool}: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in d.items())
              + " f32", flush=True)
    TB, m, n1, n2 = xv.shape
    ident = lambda a: a
    nb, m1, R = xb.shape
    # name: (kernel, plain, library closure, its conversion, inputs, outputs as
    # one tensor, flops)
    kc_lib, kc_conv = k_c_library(ar, ai, Fc)
    fu_lib, fu_conv = fused_library(xb, F, V)
    cases = {
        "op_transpose[t2d]": (lambda: op.t2d(x), lambda: op.t2d_plain(x),
                              lambda: x.T.contiguous(), ident, (x,), 0),
        "op_transpose[swap]": (lambda: op.swap(y), lambda: op.swap_plain(y),
                               lambda: y.transpose(1, 2).contiguous(), ident, (y,), 0),
        "op_gemm[gemm]": (lambda: op.gemm(A, B), lambda: op.gemm_plain(A, B),
                          lambda: torch.matmul(A, B), ident, (A, B),
                          2 * A.shape[0] * A.shape[1] * B.shape[1]),
        "op_fused_axis[fused]": (lambda: op.fused(xb, F, V), lambda: op.fused_plain(xb, F, V),
                                 fu_lib, fu_conv, (xb, F, V),
                                 nb * (R // 2) * (2 * 2 * (2 * m1) ** 2 + 2 * m1)),
        "op_transpose[k_a]": (lambda: op.k_a(x4), lambda: op.k_a_plain(x4),
                              lambda: x4.transpose(2, 3).contiguous(), ident, (x4,), 0),
        "op_transpose[k_b]": (lambda: op.k_b(xv), lambda: op.k_b_plain(xv),
                              lambda: xv.view(TB, m, n1 * n2).transpose(1, 2).contiguous(),
                              lambda a: a.view(TB, n1, n2, m), (xv,), 0),
        "op_gemm[k_c]": (lambda: op.k_c(ar, ai, Fc), lambda: op.k_c_plain(ar, ai, Fc),
                         kc_lib, kc_conv, (ar, ai, Fc),
                         2 * (ar.numel() // ar.shape[-1]) * Fc.shape[0] * Fc.shape[1]),
    }
    one = lambda r: torch.stack(r) if isinstance(r, tuple) else r
    results = {}
    for name, (kern, plain, lib, conv, _, flops) in cases.items():
        out, ref = one(kern()), one(plain())
        torch.cuda.synchronize()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        bar = 0.0 if name.startswith("op_transpose") else 1e-5
        print(f"[g] {name}: {tuple(out.shape)} kernel vs plain max_abs_err={err:.3e} "
              f"max|out|={scale:.3e} rel={err / scale:.3e} bar={bar:g}", flush=True)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all())
              and err <= bar * scale, f"{name} within {bar:g} of max|out|")
        lib_out = conv(lib())
        lib_err = float((lib_out - ref).abs().max())
        print(f"[g] {name}: one-call library vs plain max_abs_err={lib_err:.3e} "
              f"bar={bar:g}", flush=True)
        check(lib_out.shape == ref.shape and lib_err <= bar * scale,
              f"{name}: library call within {bar:g}")
        results[name] = dict(max_abs_err=err, out_bytes=out.numel() * out.element_size())
        del out, ref, lib_out

    # the path: the two tools, counts from 0
    op.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    probe_pallas_fused.main(device)
    probe_pallas_fused2.main(device)
    torch.cuda.synchronize()
    launches = {n: op.counts.launches[n] for n in OP_REPLACES}
    print(f"[g] the two tools ran in {time.time() - t0:.1f} s, launches={launches}",
          flush=True)
    check(all(launches[n] > 0 for n in OP_REPLACES), "every phase-g kernel launched by the tools")

    for name, (kern, plain, lib, _, inputs, flops) in cases.items():
        r = results[name]
        in_bytes = sum(a.numel() * a.element_size() for a in inputs)
        r["ms"], r["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
        r["bound_ms"], r["bound_by"] = bound((in_bytes + r.pop("out_bytes"), flops), "float32")
        r["library_ms"] = cuda_ms(lib)
        r["per_launch_ms"] = per_launch_ms(kern)
        r["plain_per_launch_ms"] = per_launch_ms(plain)
        for key, fn in (("device_ms", kern), ("plain_device_ms", plain),
                        ("library_device_ms", lib)):
            r[key] = device_ms(fn)
        print(f"[g] time {name}: " + ", ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "max_abs_err"), flush=True)
    print(f"[g] phase g took {time.time() - t_phase:.1f} s", flush=True)
    return results, launches


def dot_highest(a, b):
    """a against b as `op_probes.mosaic_dot` contracts them, in f32 with
    unrounded operands: the 'highest' reference of a 'default' dot."""
    a, b = a.float(), b.float()
    if a.dim() == 3:
        return a @ b
    return (a @ b.reshape(b.shape[0], -1)).reshape((a.shape[0],) + tuple(b.shape[1:]))


def bf16_mm_library(a, b):
    """torch.mm of bf16 operands with f32 output (out_dtype), a closure, or
    None where this torch has no such call for the tensors' device."""
    import torch
    try:
        torch.mm(a[:1], b[:, :1], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return None
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def mosaic_ops_library(d):
    """One PyTorch call per probe_mosaic_ops body on the inputs d of
    `probe_mosaic_ops.make_inputs`, by count name; None where no call
    computes the body's function (the 'default' dots: no call rounds f32
    operands to bf16 inside a product with f32 output)."""
    import torch
    return {"op_transpose[view1]": lambda: d["a"].reshape(64, 4096).clone(),
            "op_transpose[perm2]": lambda: d["b"].permute(2, 1, 0, 3).contiguous(),
            "op_gemm[dot3]": lambda: torch.matmul(d["F"], d["d"]),
            "op_gemm[dot4][default]": None,
            "op_transpose[view5]": lambda: d["e"].reshape(80, 32, 64).clone(),
            "op_gemm[dot6][default]": None,
            "op_transpose[view7]": lambda: d["g"].reshape(128, 32, 128).clone(),
            "op_gemm[dot8][bf16]": bf16_mm_library(d["Fb"], d["db"])}


def rep_gemm_library(acc, F, R):
    """R steps of one torch.addmm (acc [K, N]) or torch.baddbmm (acc [Z, K,
    N], F expanded over Z outside the call): 0.5 acc + 1e-3 (F @ acc)."""
    import torch
    Fz = F.expand(acc.shape[0], *F.shape) if acc.dim() == 3 else None

    def call():
        a = acc
        for _ in range(R):
            a = torch.addmm(a, F, a, beta=0.5, alpha=1e-3) if Fz is None else \
                torch.baddbmm(a, Fz, a, beta=0.5, alpha=1e-3)
        return a
    return call


def rep_swap_library(x, perm, R, s):
    """R steps of one torch.mul of the permuted view into a contiguous
    buffer, two buffers in turn (without out=, torch keeps the permuted
    strides and moves nothing)."""
    import torch
    bufs = [torch.empty_like(x) for _ in range(2)]

    def call():
        a = x
        for k in range(R):
            a = torch.mul(a.permute(perm), s, out=bufs[k % 2])
        return a
    return call


def rep_vmul_library(x, V, R, s):
    """R steps of one torch.mul by V s broadcast (V s made outside the call,
    so each step rounds x (V s), not (x V) s)."""
    import torch
    Vs = (V * s)[:, None, :, None]

    def call():
        a = x
        for _ in range(R):
            a = torch.mul(a, Vs)
        return a
    return call


def mosaic_time(r, kern, plain, lib, n_launch, n_profile):
    """Kernel, plain and library times into r: single launches (medians),
    per launch in a run of n_launch, device time per call (torch.profiler
    over 20 kernel calls and n_profile plain and library calls)."""
    r["ms"], r["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
    r["library_ms"] = None if lib is None else cuda_ms(lib)
    r["per_launch_ms"] = per_launch_ms(kern, n_launch)
    r["plain_per_launch_ms"] = per_launch_ms(plain, n_launch)
    for key, fn, n in (("device_ms", kern, 20), ("plain_device_ms", plain, n_profile),
                       ("library_device_ms", lib, n_profile)):
        r[key] = None if fn is None else device_ms(fn, n)


def mosaic_phase(device):
    """Phase h: the Mosaic op probes (rows 5-6) at the JAX tools' shapes."""
    import torch
    from dftk_tpu_torch.kernels import op_probes as op
    from dftk_tpu_torch.kernels import op_speed as osp
    from dftk_tpu_torch.tools import probe_mosaic_ops as pmo
    from dftk_tpu_torch.tools import probe_mosaic_speed as pms
    t_phase = time.time()
    check(not torch.backends.cuda.matmul.allow_tf32, "plain f32 matmuls without TF32")
    results = {}

    def hold(name, out, ref, other, bar, what):
        """Check one kernel result: exact (bar 0), within bar of max|out|,
        or (other given: the plain version at the other precision) by the
        margin rule, kernel vs plain at least BF16_MARGIN times below plain
        vs other; record the worst max_abs_err."""
        torch.cuda.synchronize()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        line = (f"[h] {name} {what}: {tuple(out.shape)} kernel vs plain max_abs_err={err:.3e} "
                f"max|out|={scale:.3e}")
        ok = out.shape == ref.shape and out.dtype == ref.dtype \
            and bool(torch.isfinite(out).all())
        if other is not None:   # in f64: at R = 100 the rep_dots are ~1e-32, their squares 0
            out64, ref64 = out.double(), ref.double()
            rel, rounding = rel_frobenius(out64, ref64), rel_frobenius(ref64, other.double())
            print(f"{line}; rel Frobenius {rel:.3e} against plain default vs highest "
                  f"{rounding:.3e}", flush=True)
            ok = ok and rel * BF16_MARGIN <= rounding
        else:
            print(f"{line} bar={bar:g}", flush=True)
            ok = ok and err <= bar * scale
        check(ok, f"{name} {what}")
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # row 5: each body on the tool's inputs of ones (every output 1.0 or
    # 64.0: all exact) and on normal inputs of the same shapes (copies and
    # permute exact, f32 and bf16-operand dots 1e-5, 'default' by the margin)
    ones, normal = pmo.make_inputs(device), pmo.make_inputs(device, ones=False, seed=7)
    print("[h] probe_mosaic_ops: " + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}"
                                                for k, v in ones.items()), flush=True)
    for (_, name, kern, plain), (_, _, kern_n, plain_n), keys in zip(
            pmo.bodies(ones), pmo.bodies(normal), pmo.ARGS):
        hold(name, kern(), plain(), None, 0.0, "ones")
        ref = plain_n()
        if "[default]" in name:
            hold(name, kern_n(), ref, dot_highest(*(normal[k] for k in keys)), None, "normal")
        else:
            hold(name, kern_n(), ref, None, 1e-5 if "gemm" in name else 0.0, "normal")
    lib5 = mosaic_ops_library(normal)
    for (_, name, _, plain) in pmo.bodies(normal):
        if lib5[name] is None:
            print(f"[h] {name}: no one-call library version", flush=True)
            continue
        ref = plain()
        out = lib5[name]()
        err, bar = float((out - ref).abs().max()), 1e-5 if "gemm" in name else 0.0
        print(f"[h] {name}: one-call library vs plain max_abs_err={err:.3e} bar={bar:g}",
              flush=True)
        check(out.shape == ref.shape and err <= bar * float(ref.abs().max()),
              f"{name}: library call within {bar:g}")

    # row 6: each body at R = 1, 3 and 100 against its plain version (the
    # swaps and kern_vm exactly; the dots by the margin rule both ways: a
    # 'default' one 10x closer to its plain version than that is to the
    # plain 'highest', and a 'highest' one 10x closer to its plain version
    # than that is to the plain 'default', which 1e-5 of max|out| cannot
    # tell, the product being ~1e-4 of acc); kern_vm is all zeros from
    # step 31 on, so R = 1, 3 carry it
    inputs = pms.make_inputs(device)
    print("[h] probe_mosaic_speed: " + "; ".join(
        ", ".join(str(tuple(t.shape)) for t in body) for body in inputs) + " f32", flush=True)
    gemm_args = dict(zip(osp.NAMES, inputs))
    perms = {"op_rep_swap[tp]": (2, 1, 0, 3), "op_rep_swap[tp2]": (1, 0, 2),
             "op_rep_swap[tp3]": (0, 2, 1)}
    for R in MOSAIC_R:
        for _, name, kern, plain, _ in pms.bodies(inputs, R):
            other = None
            if name.startswith("op_rep_gemm"):
                F, acc = gemm_args[name]
                other = osp.rep_gemm_steps(acc, F, R, "highest" if name.endswith("[default]")
                                           else "default")
            hold(name, kern(), plain(), other, 0.0, f"R={R}")

    def library6(name, R):
        if name in perms:
            return rep_swap_library(gemm_args[name][0], perms[name], R, osp.SCALE_SWAP)
        if name == "op_rep_vmul[vm]":
            return rep_vmul_library(*gemm_args[name], R, osp.SCALE_VMUL)
        if name.endswith("[default]"):
            return None         # no call rounds the operands to bf16 with f32 sums
        F, acc = gemm_args[name]
        return rep_gemm_library(acc, F, R)
    for _, name, _, plain, _ in pms.bodies(inputs, 3):
        lib = library6(name, 3)
        if lib is None:
            print(f"[h] {name}: no one-call library version", flush=True)
            continue
        out, ref = lib(), plain()
        err = float((out - ref).abs().max())
        print(f"[h] {name}: one-call library vs plain at R=3 max_abs_err={err:.3e} "
              f"bar=1e-05", flush=True)
        check(out.shape == ref.shape and err <= 1e-5 * float(ref.abs().max()),
              f"{name}: library call within 1e-5 at R=3")

    t_checks = time.time() - t_phase

    # the path: the two tools, counts from 0
    op.counts.reset()
    osp.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    pmo.main(device)
    pms.main(device)
    torch.cuda.synchronize()
    launches = {n: op.counts.launches[n] for n in op.MOSAIC_NAMES}
    launches.update(osp.counts.launches)
    print(f"[h] the two tools ran in {time.time() - t0:.1f} s, launches={launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()), "every phase-h kernel launched by the tools")

    # times and bounds: row 5 per body; row 6 at R = 100, as the tool runs them
    for (_, name, kern, plain), args in zip(pmo.bodies(normal), pmo.ARGS):
        r = results[name]
        ts = [normal[k] for k in args]
        out = kern()
        nbytes = sum(t.numel() * t.element_size() for t in ts) + out.numel() * 4
        flops = 0
        if "gemm" in name:      # a [M, K] with b [K, N...], or a [Z, M, K] @ b [Z, K, N]
            a, b = ts
            flops = 2 * a.numel() * (b.numel() // (a.shape[-1] * (a.shape[0] if a.dim() == 3
                                                                    else 1)))
        kind = "bf16" if name.endswith(("[default]", "[bf16]")) else "float32"
        r["bound_ms"], r["bound_by"] = bound((nbytes, flops), kind)
        mosaic_time(r, kern, plain, lib5[name], 100, 20)
    for _, name, kern, plain, flops in pms.bodies(inputs, pms.R):
        r = results[name]
        ts = gemm_args[name]
        n = ts[-1].numel() if name.startswith("op_rep_gemm") else ts[0].numel()
        nbytes = (sum(t.numel() for t in ts) + n) * 4
        if name.startswith("op_rep_gemm"):
            K = ts[0].shape[0]
            work = pms.R * (n // K * (2 * K * K) + 3 * n)
        else:
            work = pms.R * n * (2 if name == "op_rep_vmul[vm]" else 1)
        kind = "bf16" if name.endswith("[default]") else "float32"
        r["bound_ms"], r["bound_by"] = bound((nbytes, work), kind)
        mosaic_time(r, kern, plain, library6(name, pms.R), 10, 3)   # 100-400 kernels a call
        # rates from the event time per launch in a run: device-bound at R = 100
        if flops:
            r["tflops"] = flops * pms.R / r["per_launch_ms"] / 1e9
        if name.startswith("op_rep_gemm"):
            r["smem_bytes_per_block"] = osp.gemm_smem(ts[0].shape[0])
        if name in perms:       # each step reads and writes each value in shared memory
            _, P, _, _, L = op.swap_dims(ts[0].shape, perms[name])
            r["smem_bytes_per_block"] = osp.swap_smem(P, L)
            r["smem_bytes_per_step"] = 8 * n
            r["smem_TBps"] = 8 * n * pms.R / r["per_launch_ms"] / 1e9
    for name, r in results.items():
        print(f"[h] time {name}: " + ", ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "max_abs_err"), flush=True)
    print("[h] tflops and smem_TBps (the swaps' shared-memory traffic, 8 bytes per value "
          "per step) are over per_launch_ms; smem_TBps is not a bound from the data sheet",
          flush=True)
    print(f"[h] phase h took {time.time() - t_phase:.1f} s (checks {t_checks:.1f} s)",
          flush=True)
    return results, launches


def probe_phase(device):
    """Phase e: the filter-stage probe kernels at the JAX probes' shapes."""
    import torch
    from dftk_tpu_torch.kernels import filter_stages as fs
    from dftk_tpu_torch.tools import (probe_harness, probe_kernel_incr, probe_kernel_pipe,
                                      probe_kernel_variants, probe_pallas_fixed)
    check(not torch.backends.cuda.matmul.allow_tf32, "plain f32 matmuls without TF32")
    dims = PROBE_DIMS
    t, V, F = probe_harness.make_inputs(2, *dims, 1.0, 8, device)
    print(f"[e] t {tuple(t.shape)} f32 ({t.numel() * 4 / 1e6:.1f} MB), V "
          f"{tuple(V.shape)}, factors {[tuple(f.shape) for f in F]}", flush=True)
    # label: (count name, kernel, plain, stages, kind, one-call library or None)
    cases = {"probe_copy": ("probe_copy", lambda: fs.probe_copy(t),
                            lambda: fs.probe_copy_plain(t), None, "float32",
                            lambda: torch.mul(t, fs.COPY_SCALE)),
             "copy zblk=8": ("probe_copy", lambda: fs.probe_copy(t, 8),
                             lambda: fs.probe_copy_plain(t), None, "float32", None)}
    for label, stages, prec, zblk in (
            ("f2", "f2", "highest", 1), ("f2_rep", "f2_rep", "highest", 1),
            ("f2_rep_f1", "f2_rep_f1", "highest", 1), ("full", "full", "highest", 1),
            ("full zblk=4", "full", "highest", 4), ("full zblk=8", "full", "highest", 8),
            ("full bf16", "full", "default", 1), ("rep", "rep", "highest", 1),
            ("dots", "dots", "highest", 1)):
        f = None if stages == "rep" else F
        # bf16 has none: a bf16 einsum rounds the V product and the output too
        lib = stage_library(stages, t, V, F) if prec == "highest" and zblk == 1 else None
        cases[label] = (
            fs.count_name(stages, prec),
            lambda s=stages, p=prec, z=zblk, f=f: fs.probe_stages(t, V, f, s, p, z),
            lambda s=stages, p=prec, f=f: fs.probe_stages_plain(t, V, f, s, p),
            stages, "bf16" if prec == "default" else "float32", lib)
    print(f"[e] torch.einsum contraction path from opt_einsum: "
          f"{torch.backends.opt_einsum.enabled}", flush=True)
    results = {}
    for label, (name, kern, plain, stages, kind, lib) in cases.items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        line = f"[e] {label}: kernel vs plain max_abs_err={err:.3e} max|out|={scale:.3e}"
        if kind == "bf16":
            hi = fs.probe_stages_plain(t, V, F, "full")
            rel, rounding = rel_frobenius(out, ref), rel_frobenius(ref, hi)
            print(f"{line}; rel Frobenius {rel:.3e} against plain default vs highest "
                  f"{rounding:.3e}", flush=True)
            check(rel * BF16_MARGIN <= rounding, f"probe {label}: kernel-vs-plain "
                  f"{BF16_MARGIN}x below default-vs-highest")
        else:
            print(f"{line} rel={err / scale:.3e} bar=1e-05", flush=True)
            check(err <= 1e-5 * scale, f"probe {label} within 1e-5")
        if lib is not None:
            lib_err = float((lib() - ref).abs().max())
            print(f"[e] {label}: one-call library vs plain max_abs_err={lib_err:.3e} "
                  f"bar=1e-05", flush=True)
            check(lib_err <= 1e-5 * scale, f"probe {label}: library call within 1e-5")
        del out, ref
        results[label] = dict(name=name, max_abs_err=err)

    # the path: the four probe tools, counts from 0
    fs.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    fixed = probe_pallas_fixed.main(device)
    for tool in (probe_kernel_pipe, probe_kernel_variants, probe_kernel_incr):
        tool.main(device)
    torch.cuda.synchronize()
    launches = dict(fs.counts.launches)
    print(f"[e] the four probe tools ran in {time.time() - t0:.1f} s, launches={launches}",
          flush=True)
    check(all(launches[n] > 0 for n in PROBE_REPLACES),
          "every probe kernel launched by the tools")

    for label, (name, kern, plain, stages, kind, lib) in cases.items():
        r = results[label]
        r["ms"], r["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
        r["bound_ms"], r["bound_by"] = bound(stage_work(stages, *dims), kind)
        r["library_ms"] = None if lib is None else cuda_ms(lib)
        print(f"[e] time {label}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k not in ("name", "max_abs_err")), flush=True)
    print(f"[e] copy chain slope 10->100 launches: {fixed['slope_ms']:.4f} ms per launch, "
          f"intercept {fixed['intercept_ms']:.4f} ms per chain; torch.mul per call in "
          f"chains of 10/100: {fixed['mult_per_iter'][10]:.4f}/"
          f"{fixed['mult_per_iter'][100]:.4f} ms", flush=True)
    return {r["name"]: r for label, r in results.items()
            if label not in ("copy zblk=8", "full zblk=4", "full zblk=8")}, launches


def timed_on_card(fn):
    """fn() with the wall times (ms, CUDA-synchronised) of a first call and
    of a second, and the peak device memory a call allocated above what was
    held before it (MiB)."""
    import torch
    ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def derivatives_phase(dt, la, device, smi):
    """Phase i: forces and stresses of a displaced Si54 on the card."""
    import types
    import torch
    from dftk_tpu_torch.ops.engine_split import prepare_split_data
    from dftk_tpu_torch.ops.forces_split import compute_forces_split
    from dftk_tpu_torch.ops.stresses_split import compute_stresses_split
    from dftk_tpu_torch.scf.energy_eval import split_state_to_complex
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_si54_derivatives.json")) as f:
        ref = json.load(f)
    F_ref, S_ref = np.array(ref["forces_cart"]), np.array(ref["stresses_cart"])
    builder, positions, _ = displaced_si54()
    model = builder(positions)
    basis = dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)

    def show(info):
        print(f"[i] it={info['n_iter']:3d} E={info['E']:.12f} drho={info['drho']:.3e} "
              f"t={time.time() - t0:.1f}s", flush=True)

    def report(label, F, S, F_ms, F_mib, S_ms, S_mib, bar_F, bar_S):
        F, S = F.cpu().numpy(), S.cpu().numpy()
        dF, dS = np.abs(F - F_ref).max(), np.abs(S - S_ref).max()
        drift = np.abs(F.sum(0)).max()
        print(f"[i] {label}: forces {F_ms[0]:.1f} ms (again {F_ms[1]:.1f}), peak "
              f"{F_mib:.1f} MiB; stresses {S_ms[0]:.1f} ms (again {S_ms[1]:.1f}), peak "
              f"{S_mib:.1f} MiB ({smi}); max|F - F_ref| = {dF:.3e} "
              f"Ha/bohr, max|S - S_ref| = {dS:.3e} Ha/bohr^3, max|sum F| = {drift:.3e}",
              flush=True)
        check(np.all(np.isfinite(F)) and F.shape == F_ref.shape
              and np.all(np.isfinite(S)) and S.shape == (3, 3),
              f"{label}: finite forces and stresses of their shapes")
        check(dF < bar_F, f"{label}: forces within {bar_F} Ha/bohr of the JAX package's")
        check(dS < bar_S, f"{label}: stresses within {bar_S} Ha/bohr^3 of the JAX package's")
        check(drift < SUM_RULE_TOL, f"{label}: forces sum to under {SUM_RULE_TOL}")

    # the LOBPCG SCF to 1e-10, then both derivatives
    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field(basis, tol=1e-10, is_converged="density", callback=show)
    torch.cuda.synchronize()
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    dE = res.total_energy - ref["total_energy"]
    print(f"[i] SCF converged={res.converged} n_iter={res.n_iter} wall="
          f"{time.time() - t0:.2f} s E={res.total_energy:.12f} dE={dE:.3e} "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(res.converged and abs(dE) < E_TOL, f"displaced SCF converged, |E - E_ref| < {E_TOL}")
    check(launches["pruned_axis_dft"] > 0 and launches["local_plane"] > 0,
          "every complex128 kernel launched in the displaced SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the displaced SCF")
    F, F_ms, F_mib = timed_on_card(lambda: dt.compute_forces_cart(res))
    S, S_ms, S_mib = timed_on_card(lambda: dt.compute_stresses_cart(res))
    check(F.device.type == "cuda" and S.device.type == "cuda", "derivatives on the card")
    report("LOBPCG", F, S, F_ms, F_mib, S_ms, S_mib, FORCE_TOL, STRESS_TOL)
    del res

    # the split CheFSI SCF ("mixed" filter) to 1e-8, then the split adapters
    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    sres = dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=60, eigensolver="chefsi", chebyshev_degree=10,
        chefsi_cycles=2, is_converged="density", filter_precision="mixed")
    torch.cuda.synchronize()
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    dE = sres["energies"]["total"] - ref["total_energy"]
    print(f"[i] split SCF converged={sres['converged']} n_iter={sres['n_iter']} wall="
          f"{time.time() - t0:.2f} s E={sres['energies']['total']:.12f} dE={dE:.3e} "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(sres["converged"] and abs(dE) < E_TOL,
          f"displaced split SCF converged, |E - E_ref| < {E_TOL}")
    check(all(v > 0 for v in launches.values()), "every kernel launched in the split SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the split SCF")
    sd = prepare_split_data(basis)
    U, occ, rho = sres["U"], sres["occupation"], sres["rho"]
    Fs, Fs_ms, Fs_mib = timed_on_card(lambda: compute_forces_split(basis, sd, U, occ, rho))
    Ss, Ss_ms, Ss_mib = timed_on_card(lambda: compute_stresses_split(basis, sd, U, occ))
    psi, occ_c = split_state_to_complex(basis, U, occ)
    state = types.SimpleNamespace(psi=psi, occupation=occ_c, rho=rho)
    dFc = float((Fs - dt.compute_forces(state, basis)).abs().max())
    dSc = float((Ss - dt.compute_stresses_cart(state, basis)).abs().max())
    print(f"[i] split adapters against the complex path on the same state: forces "
          f"{dFc:.3e}, stresses {dSc:.3e}", flush=True)
    check(dFc < ADAPTER_TOL and dSc < ADAPTER_TOL,
          f"split adapters within {ADAPTER_TOL} of the complex path")
    Fs_cart = Fs @ torch.as_tensor(np.linalg.inv(model.lattice), device=Fs.device)
    report("split", Fs_cart, Ss, Fs_ms, Fs_mib, Ss_ms, Ss_mib, SPLIT_TOL, SPLIT_TOL)
    print(f"[i] phase i took {time.time() - t_phase:.1f} s", flush=True)


def symmetry_engine(model):
    """Which engine found the model's operations: the native engine, or the
    numpy path where the engine's buffer of operations is too small."""
    from dftk_tpu_torch.utils.native import native_symmetry_operations
    types = [model.atoms.index(at) for at in model.atoms]
    found = native_symmetry_operations(model.lattice, np.stack(model.positions), types)
    return "native" if found is not None else "numpy path"


def si8_model(dt, displacement=0.0):
    """Si8 conventional cubic (fcc sites +-(1/8, 1/8, 1/8)), atom 0 moved
    by displacement * (1, 1, 1) in reduced coordinates, default symmetries."""
    fcc = [np.array(p, dtype=float) for p in ([0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0])]
    positions = [f + s * np.ones(3) / 8 for f in fcc for s in (1, -1)]
    positions[0] = positions[0] + displacement * np.ones(3)
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    return dt.model_DFT(np.eye(3) * 2 * A_SI, [Si] * 8, positions,
                        functionals=["lda_x", "lda_c_vwn"])


def run_on_card(la, label, smi, fn, tag="j"):
    """fn() with the counts set to 0 just before it, its wall time
    (CUDA-synchronised) and peak device memory; checks that kernels A and
    B launched and that no plain version was called.  Returns (result,
    launches)."""
    import torch
    la.counts.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    print(f"[{tag}] {label}: wall {wall:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB ({smi}); "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(launches["pruned_axis_dft"] > 0 and launches["local_plane"] > 0,
          f"{label}: every complex128 kernel launched")
    check(all(v == 0 for v in plain.values()), f"{label}: no plain version called")
    return out, launches


def hold_kernels_at(la, basis, label, n_bands, errs, bf16=False, tag="j", stack=1, block=None,
                    bar=None):
    """Kernels A and B (and the A -> B -> A chain) against their plain
    versions on one band block of the SCF at the basis' own shapes, with a
    seeded potential of its own on every k row (under collinear spin the
    two halves of the rows differ as the spin channels do): in complex128
    at BARS, and in bf16 (where the path runs it) by the BF16_MARGIN rule.
    stack: the block's bands times this (3: a meta-GGA's DivAgrad batch,
    the three p_a-scaled copies of the block in one apply).  block: the
    block's bands where they are not n_bands plus the SCF's default extra
    bands (an operator on the occupied bands only, or explicit extras).
    Called before
    run_on_card, whose counts start after it.  bar: the complex128 bar
    relative to max|out| (default BARS).  Adds each kernel's max_abs_err at
    this path to errs[name][label]."""
    import torch
    bar = BARS["complex128"] if bar is None else bar
    pf, n = basis.pruned, basis.fft_size
    rng = np.random.default_rng(20261017)
    block = block or n_bands + max(3, n_bands // 10)
    shape = (basis.n_kpoints, stack * block) + pf.m_shape
    xc_np = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    V_np = rng.normal(size=(basis.n_kpoints, n[2], n[0], n[1]))
    for dtype, prec in ((torch.complex128, "highest"),) + (
            ((torch.complex64, "default"),) if bf16 else ()):
        fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in pf.factors.fwd),
                              bwd=tuple(f.to(dtype) for f in pf.factors.bwd))
        xc = torch.as_tensor(xc_np, device=basis.device).to(dtype)
        V = torch.as_tensor(V_np, device=basis.device).to(
            torch.float64 if dtype == torch.complex128 else torch.float32)
        t = la.pruned_axis_dft_plain(xc, fac.fwd[2], True, prec).contiguous()
        sfx = "" if prec == "highest" else "[bf16]"
        cases = {
            "pruned_axis_dft": (lambda: la.pruned_axis_dft(xc, fac.fwd[2], True, prec),
                                lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True, prec),
                                lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
            "local_plane": (lambda: la.local_plane(t, V, fac, precision=prec),
                            lambda: la.local_plane_plain(t, V, fac, prec),
                            lambda: la.local_plane_plain(t, V, fac)),
            "local_apply": (lambda: la.local_apply(xc, V, fac, prec),
                            lambda: la.local_apply_plain(xc, V, fac, prec),
                            lambda: la.local_apply_plain(xc, V, fac)),
        }
        for name, (kern, plain, highest) in cases.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if prec == "highest":
                scale = float(ref.abs().max())
                print(f"[{tag}] {label} {name}{sfx} at x {tuple(xc.shape)}, grid {n}: "
                      f"max_abs_err={err:.3e} rel={err / scale:.3e} "
                      f"bar={bar:.0e}", flush=True)
                check(err <= bar * scale, f"{label}: {name} within {bar}")
            else:
                rel, rounding = rel_frobenius(out, ref), rel_frobenius(ref, highest())
                print(f"[{tag}] {label} {name}{sfx} at x {tuple(xc.shape)}, grid {n}: "
                      f"max_abs_err={err:.3e} rel={rel:.3e}; plain default vs highest "
                      f"rel={rounding:.3e}", flush=True)
                check(rel * BF16_MARGIN <= rounding,
                      f"{label}: {name}{sfx} {BF16_MARGIN}x below default-vs-highest")
            if name != "local_apply":
                errs.setdefault(name + sfx, {})[label] = err


def time_symmetrizer(basis, label, smi, tag="j"):
    """The symmetrizer's build (the maps on the host, then on the card) and
    one application on the card (CUDA-synchronised, the median of 5 after
    one warm-up).  The basis keeps it for the SCF."""
    import torch
    from dftk_tpu_torch.ops.density import make_symmetrizer
    torch.cuda.synchronize()
    t0 = time.time()
    sym = make_symmetrizer(basis)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    rho = torch.rand((1,) + basis.fft_size, dtype=torch.float64, device=basis.device,
                     generator=torch.Generator(basis.device).manual_seed(3))
    ms = cuda_ms(lambda: sym(rho), reps=5, warmup=1)
    print(f"[{tag}] {label} symmetrizer: {len(basis.symmetries)} operations, "
          f"{len({op.W for op in basis.symmetries})} rotations, grid {basis.fft_size}: "
          f"built in {t_build:.2f} s, one application {ms:.3f} ms ({smi})", flush=True)


def symmetry_phase(dt, la, device, smi):
    """Phase j: the default model's crystal symmetry on the card: the ABINIT
    golden, symmetric and displaced Si8 on a Monkhorst-Pack grid, and the
    symmetric Si54 split SCF.  Returns the kernel launches of its runs and
    each kernel's max_abs_err against its plain version at each run's
    shapes."""
    import torch
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_symmetry.json")) as f:
        ref = json.load(f)
    total, errs = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # j1: the ABINIT golden at its full size (tests/test_silicon_scf.py::
    # test_silicon_lda_large's configuration)
    ab = ref["abinit_silicon_lda"]
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
    model = dt.model_DFT(lattice, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x", "lda_c_vwn"])
    basis = dt.PlaneWaveBasis(model, Ecut=25.0, kgrid=dt.ExplicitKpoints(*ab["kpoints"]),
                              fft_size=(33, 33, 33), device=device)
    print(f"[j1] {basis}, engine: {symmetry_engine(model)}", flush=True)
    hold_kernels_at(la, basis, "j1", 8, errs)
    res, launches = run_on_card(la, "j1 golden LOBPCG SCF", smi, lambda: dt.self_consistent_field(
        basis, tol=1e-9, is_converged="energy", n_bands=8))
    add(launches)
    dev = np.abs(res.eigenvalues[:, :8] - np.array(ab["eigenvalues"])).max()
    dE = res.total_energy - ab["total_energy"]
    degen = abs(res.eigenvalues[0][1] - res.eigenvalues[0][3])
    print(f"[j1] converged={res.converged} n_iter={res.n_iter} E={res.total_energy:.12f} "
          f"E - E_ABINIT={dE:.3e}; max|eigenvalue - ABINIT|={dev:.3e}; k=0 triple "
          f"degeneracy {degen:.3e}", flush=True)
    check(res.converged and abs(dE) < SYM_ABINIT_TOL and dev < SYM_ABINIT_TOL,
          f"j1: energy and eigenvalues within {SYM_ABINIT_TOL} of ABINIT")
    check(degen < SYM_DEGENERACY_TOL, f"j1: k=0 degeneracy within {SYM_DEGENERACY_TOL}")
    del res, basis

    # j2: Si8 conventional on MonkhorstPack (4, 4, 4) at Ecut 20, symmetric
    # then with atom 0 moved along [111]
    for key, disp in (("si8_symmetric", 0.0), ("si8_displaced", SI8_DISPLACEMENT)):
        r = ref[key]
        model = si8_model(dt, disp)
        basis = dt.PlaneWaveBasis(model, Ecut=20.0, kgrid=dt.MonkhorstPack((4, 4, 4)),
                                  device=device)
        print(f"[j2] {key}: {basis}, engine: {symmetry_engine(model)}", flush=True)
        check(len(basis.symmetries) == r["n_symmetries"] and list(basis.fft_size) == r["fft_size"]
              and np.array_equal(basis.kcoords, np.array(r["kcoords"]))
              and np.array_equal(basis.kweights, np.array(r["kweights"])),
              f"j2 {key}: k-points, weights, symmetries and FFT size equal the JAX package's")
        time_symmetrizer(basis, f"j2 {key}", smi)
        hold_kernels_at(la, basis, f"j2 {key}", model.default_n_bands(), errs)
        res, launches = run_on_card(la, f"j2 {key} LOBPCG SCF", smi,
                                    lambda: dt.self_consistent_field(basis, tol=1e-10))
        add(launches)
        F, F_ms, F_mib = timed_on_card(lambda: dt.compute_forces_cart(res))
        S, S_ms, S_mib = timed_on_card(lambda: dt.compute_stresses_cart(res))
        F, S = F.cpu().numpy(), S.cpu().numpy()
        dE = res.total_energy - r["total_energy"]
        dF = np.abs(F - np.array(r["forces_cart"])).max()
        dS = np.abs(S - np.array(r["stresses_cart"])).max()
        print(f"[j2] {key}: converged={res.converged} n_iter={res.n_iter} "
              f"E={res.total_energy:.12f} dE={dE:.3e}; forces {F_ms[0]:.1f} ms (again "
              f"{F_ms[1]:.1f}), peak {F_mib:.1f} MiB, max|F - F_ref|={dF:.3e}, max|F|="
              f"{np.abs(F).max():.3e}; stresses {S_ms[0]:.1f} ms (again {S_ms[1]:.1f}), "
              f"peak {S_mib:.1f} MiB, max|S - S_ref|={dS:.3e} ({smi})", flush=True)
        check(res.converged and abs(dE) < SI8_E_TOL,
              f"j2 {key}: |E - E_JAX| < {SI8_E_TOL}")
        check(np.all(np.isfinite(F)) and np.all(np.isfinite(S)), f"j2 {key}: finite derivatives")
        check(dS < STRESS_TOL, f"j2 {key}: stresses within {STRESS_TOL} of the JAX package's")
        if disp == 0.0:
            check(np.abs(F).max() < SI8_ZERO_FORCE_TOL,
                  f"j2 {key}: forces vanish (< {SI8_ZERO_FORCE_TOL})")
        else:
            check(dF < FORCE_TOL, f"j2 {key}: forces within {FORCE_TOL} of the JAX package's")
        del res, basis

    # j3: bench.py's Si54 under the default model (no fft_size: 72^3), the
    # split CheFSI SCF with the "mixed" filter and symmetrize=True
    m = build_bench_basis(3, 10.0, device).model
    t0 = time.time()
    model = dt.model_DFT(m.lattice, m.atoms, m.positions, functionals=["lda_x", "lda_c_vwn"])
    t_model = time.time() - t0
    basis = dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)
    r = ref["si54_symmetric"]
    print(f"[j3] {basis}: operations found in {t_model:.2f} s, engine: "
          f"{symmetry_engine(model)}; basis in {time.time() - t0 - t_model:.2f} s", flush=True)
    check(len(basis.symmetries) == r["n_symmetries"] and list(basis.fft_size) == r["fft_size"],
          "j3: symmetries and FFT size equal the JAX package's")
    time_symmetrizer(basis, "j3 Si54", smi)
    hold_kernels_at(la, basis, "j3", model.default_n_bands(), errs, bf16=True)
    res, launches = run_on_card(la, "j3 Si54 split CheFSI SCF", smi,
                                lambda: dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=60, eigensolver="chefsi", chebyshev_degree=10,
        chefsi_cycles=2, is_converged="density", filter_precision="mixed",
        symmetrize=True))
    add(launches)
    E = res["energies"]["total"]
    with open(os.path.join(HERE, "tests", "data", "torch_port_si54.json")) as f:
        E_free = json.load(f)["total_energy"]
    print(f"[j3] converged={res['converged']} n_iter={res['n_iter']} E={E:.12f} "
          f"E - E_JAX={E - r['total_energy']:.3e}; E - E_ref(symmetry-free, 64^3)="
          f"{E - E_free:.3e}", flush=True)
    check(res["converged"] and abs(E - r["total_energy"]) < E_TOL,
          f"j3: |E - E_JAX| < {E_TOL}")
    check(all(v > 0 for v in launches.values()), "j3: every kernel launched")
    print(f"[j] phase j took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


def fe_bcc_cell(n, displacement=None):
    """The bcc iron conventional cube repeated n times along each axis:
    lattice and fractional positions (the corner atom then the body centre
    of each cube, cubes in i, j, k order); atom 1 moved by displacement (the
    cells of tests/data/make_torch_port_metals.py)."""
    pos = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                c = np.array([i, j, k], dtype=float)
                pos += [c / n, (c + 0.5) / n]
    if displacement is not None:
        pos[1] = pos[1] + np.array(displacement)
    return A_FE * n * np.eye(3), pos


def fe_model(dt, lattice, positions, functionals):
    """Iron (HGH lda/fe-q8) with moment 4 on each atom, FermiDirac T = 0.01."""
    Fe = dt.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    return dt.model_DFT(lattice, [Fe] * len(positions), positions, functionals=functionals,
                        temperature=0.01, smearing=dt.Smearing.FermiDirac(),
                        magnetic_moments=[4.0] * len(positions))


def spin_summary(dt, basis, rho, occupation):
    """(magnetisation, electrons in rho, electrons in the occupations)."""
    import torch
    occ = torch.as_tensor(occupation, device=basis.device)
    w = torch.as_tensor(basis.kweights, device=basis.device)
    return (float(dt.spin_density(rho).sum()) * basis.dvol, float(rho.sum()) * basis.dvol,
            float(torch.sum(w[:, None] * occ)))


def match_rows(ev, ref):
    """The largest deviation of the rows of ev [n, nb] matched one to one
    onto the rows of ref, each to the closest unused one (the ABINIT table's
    k-point order differs: tests/test_metals_spin.py::test_iron_pbe_golden)."""
    dev = np.abs(ev[:, None, :] - ref[None, :, :]).max(-1)
    used, worst = set(), 0.0
    for i in range(len(ev)):
        j = int(np.argmin([np.inf if c in used else dev[i, c] for c in range(len(ref))]))
        used.add(j)
        worst = max(worst, dev[i, j])
    return worst if len(used) == len(ref) else np.inf


def metals_phase(dt, la, device, smi):
    """Phase k: metals, collinear spin and GGA on the card: the ABINIT iron
    LDA and PBE and silicon PBE goldens, aluminium under cold smearing with
    LdosMixing, the derivatives of a displaced magnetic Fe2 cell, and the
    ferromagnetic Fe16 and Fe54 split SCFs.  Returns the kernel launches of
    its runs and each kernel's max_abs_err at each run's shapes."""
    import types
    import torch
    from dftk_tpu_torch.ops.engine_split import prepare_split_data
    from dftk_tpu_torch.ops.forces_split import compute_forces_split
    from dftk_tpu_torch.ops.stresses_split import compute_stresses_split
    from dftk_tpu_torch.scf.energy_eval import split_state_to_complex
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_metals.json")) as f:
        ref = json.load(f)
    total, errs = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def scf_line(label, basis, res, r):
        E = res.total_energy if hasattr(res, "total_energy") else res["energies"]["total"]
        rho = res.rho if hasattr(res, "rho") else res["rho"]
        occ = res.occupation if hasattr(res, "occupation") else res["occupation"]
        n_iter = res.n_iter if hasattr(res, "n_iter") else res["n_iter"]
        conv = res.converged if hasattr(res, "converged") else res["converged"]
        magn, n_rho, n_occ = spin_summary(dt, basis, rho, occ)
        dE = E - r["total_energy"]
        print(f"[{label}] converged={conv} n_iter={n_iter} E={E:.12f} E - E_JAX={dE:.3e}; "
              f"magnetisation {magn:.8f} (JAX {r.get('magnetisation', 0.0):.8f}); electrons "
              f"{n_rho:.12f} in rho, {n_occ:.12f} in the occupations ({smi})", flush=True)
        check(conv and np.isfinite(E), f"{label}: converged to a finite energy")
        check(abs(dE) < METAL_E_TOL, f"{label}: |E - E_JAX| < {METAL_E_TOL}")
        return E, magn, n_rho, n_occ

    # k1: the ABINIT iron goldens, LOBPCG (tests/test_metals_spin.py)
    kgrid = dt.MonkhorstPack((4, 4, 4), (0.5, 0.5, 0.5))
    Fe = dt.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    model = dt.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals=("lda_xc_teter93",),
                         temperature=0.01, magnetic_moments=[4.0],
                         smearing=dt.Smearing.FermiDirac())
    basis = dt.PlaneWaveBasis(model, Ecut=15.0, fft_size=(20, 20, 20), kgrid=kgrid,
                              device=device)
    print(f"[k1] iron LDA: {basis}", flush=True)
    hold_kernels_at(la, basis, "k1", 8, errs, tag="k1")
    res, launches = run_on_card(la, "k1 iron LDA golden LOBPCG SCF", smi, lambda: (
        dt.self_consistent_field(basis, tol=1e-8, rho=dt.guess_density(basis, [4.0]),
                                 n_bands=8, maxiter=60)), tag="k1")
    add(launches)
    E, magn, _, _ = scf_line("k1 iron LDA", basis, res, ref["iron_lda_golden"])
    ab = ref["abinit_iron_lda"]["total_energy"]
    print(f"[k1] iron LDA: E - E_ABINIT={E - ab:.3e}", flush=True)
    check(abs(E - ab) < METAL_ABINIT_TOL and 2.3 < magn < 2.7,
          f"k1 iron LDA: E within {METAL_ABINIT_TOL} of ABINIT, magnetisation in (2.3, 2.7)")
    del res, basis

    model = dt.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals="PBE",
                         temperature=0.01, spin_polarization="collinear")
    basis = dt.PlaneWaveBasis(model, Ecut=20.0, fft_size=(20, 20, 20), kgrid=kgrid,
                              device=device)
    print(f"[k1] iron PBE: {basis}", flush=True)
    hold_kernels_at(la, basis, "k1 PBE", 10, errs, tag="k1")
    res, launches = run_on_card(la, "k1 iron PBE golden LOBPCG SCF", smi, lambda: (
        dt.self_consistent_field(basis, tol=1e-12, rho=dt.guess_density(basis, [4.0]),
                                 n_bands=10, maxiter=100)), tag="k1")
    add(launches)
    E, magn, _, _ = scf_line("k1 iron PBE", basis, res, ref["iron_pbe_golden"])
    ab = ref["abinit_iron_pbe"]
    worst = match_rows(np.sort(res.eigenvalues[:, :10], axis=1), np.array(ab["eigenvalues"]))
    print(f"[k1] iron PBE: E - E_ABINIT={E - ab['total_energy']:.3e}, magnetisation - "
          f"reference={magn - ab['magnetisation']:.3e}; 12 (k, spin) rows matched onto ABINIT's: "
          f"max deviation {worst:.3e}", flush=True)
    check(res.eigenvalues.shape[0] == 12 and worst < IRON_EIG_TOL,
          f"k1 iron PBE: every (k, spin) eigenvalue row within {IRON_EIG_TOL} of ABINIT's")
    check(abs(E - ab["total_energy"]) < METAL_ABINIT_TOL
          and abs(magn - ab["magnetisation"]) < IRON_MAGN_TOL,
          f"k1 iron PBE: E within {METAL_ABINIT_TOL} of ABINIT, magnetisation within "
          f"{IRON_MAGN_TOL}")
    del res, basis

    # k2: the ABINIT silicon PBE golden (tests/test_silicon_pbe.py)
    ab = ref["abinit_silicon_pbe"]
    Si = dt.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
    model = dt.model_DFT(lattice, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals="PBE")
    basis = dt.PlaneWaveBasis(model, Ecut=25.0, kgrid=dt.ExplicitKpoints(*ab["kpoints"]),
                              fft_size=(33, 33, 33), device=device)
    print(f"[k2] silicon PBE: {basis}", flush=True)
    hold_kernels_at(la, basis, "k2", 8, errs, tag="k2")
    res, launches = run_on_card(la, "k2 silicon PBE golden LOBPCG SCF", smi, lambda: (
        dt.self_consistent_field(basis, tol=1e-9, n_bands=8, is_converged="energy")), tag="k2")
    add(launches)
    E, _, _, _ = scf_line("k2 silicon PBE", basis, res, ref["silicon_pbe_golden"])
    dev = np.abs(res.eigenvalues[0][:8] - np.array(ab["eigenvalues_k0"])).max()
    print(f"[k2] silicon PBE: E - E_ABINIT={E - ab['total_energy']:.3e}, max|k=0 eigenvalue "
          f"- ABINIT|={dev:.3e}", flush=True)
    check(abs(E - ab["total_energy"]) < METAL_ABINIT_TOL and dev < METAL_ABINIT_TOL,
          f"k2 silicon PBE: energy and k = 0 eigenvalues within {METAL_ABINIT_TOL} of ABINIT")
    del res, basis

    # k3: Al4 under Marzari-Vanderbilt smearing with LdosMixing
    Al = dt.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dt.model_DFT(AL_LATTICE, [Al] * 4, AL_POSITIONS, functionals=["lda_x", "lda_c_pw"],
                         temperature=AL_SMEARING_WIDTH,
                         smearing=dt.Smearing.MarzariVanderbilt())
    basis = dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=dt.MonkhorstPack((1, 3, 3)), device=device)
    print(f"[k3] aluminium: {basis}", flush=True)
    hold_kernels_at(la, basis, "k3", model.default_n_bands(), errs, tag="k3")
    res, launches = run_on_card(la, "k3 Al4 cold smearing LdosMixing LOBPCG SCF", smi, lambda: (
        dt.self_consistent_field(basis, tol=1e-10, mixing=dt.LdosMixing(), maxiter=100)),
        tag="k3")
    add(launches)
    _, _, n_rho, n_occ = scf_line("k3 Al4", basis, res, ref["aluminium_mv_ldos"])
    check(abs(n_occ - 12) < N_ELECTRONS_TOL and abs(n_rho - 12) < N_ELECTRONS_TOL,
          f"k3 Al4: 12 electrons within {N_ELECTRONS_TOL}")
    del res, basis

    # k4: forces and stresses of the displaced magnetic Fe2 cell, PBE
    r = ref["fe2_pbe_derivatives"]
    agree = r["two_runs_agree"]
    bar_F = min(max(FORCE_TOL, 10 * agree["forces"]), SPLIT_TOL)
    bar_S = min(max(STRESS_TOL, 10 * agree["stresses"]), SPLIT_TOL)
    lattice, pos = fe_bcc_cell(1, FE2_DISPLACEMENT)
    model = fe_model(dt, lattice, pos, "PBE")
    basis = dt.PlaneWaveBasis(model, Ecut=15.0, kgrid=dt.MonkhorstPack((3, 3, 3)), device=device)
    print(f"[k4] Fe2: {basis}; bars {bar_F:.1e} Ha/bohr, {bar_S:.1e} Ha/bohr^3 (two JAX SCFs "
          f"agree to {agree['forces']:.1e} and {agree['stresses']:.1e})", flush=True)
    hold_kernels_at(la, basis, "k4", model.default_n_bands(), errs, bf16=True, tag="k4")
    F_ref, S_ref = np.array(r["forces_cart"]), np.array(r["stresses_cart"])
    res, launches = run_on_card(la, "k4 Fe2 LOBPCG SCF", smi, lambda: (
        dt.self_consistent_field(basis, tol=1e-10, rho=dt.guess_density(basis, [4.0, 4.0]),
                                 maxiter=100)), tag="k4")
    add(launches)
    scf_line("k4 Fe2", basis, res, r)
    F, F_ms, F_mib = timed_on_card(lambda: dt.compute_forces_cart(res))
    S, S_ms, S_mib = timed_on_card(lambda: dt.compute_stresses_cart(res))
    dF = np.abs(F.cpu().numpy() - F_ref).max()
    dS = np.abs(S.cpu().numpy() - S_ref).max()
    print(f"[k4] LOBPCG: forces {F_ms[0]:.1f} ms (again {F_ms[1]:.1f}), peak {F_mib:.1f} MiB, "
          f"max|F - F_JAX|={dF:.3e}; stresses {S_ms[0]:.1f} ms (again {S_ms[1]:.1f}), peak "
          f"{S_mib:.1f} MiB, max|S - S_JAX|={dS:.3e} ({smi})", flush=True)
    check(F.device.type == "cuda" and bool(torch.isfinite(F).all() and torch.isfinite(S).all()),
          "k4: finite derivatives on the card")
    check(dF < bar_F and dS < bar_S, f"k4: forces within {bar_F:.1e}, stresses within "
          f"{bar_S:.1e} of the JAX package's")
    del res
    sres, launches = run_on_card(la, "k4 Fe2 split CheFSI SCF", smi, lambda: (
        dt.self_consistent_field_split(
            basis, tol=1e-8, maxiter=80, eigensolver="chefsi", chebyshev_degree=10,
            chefsi_cycles=2, is_converged="density", filter_precision="mixed",
            rho0=dt.guess_density(basis, [4.0, 4.0]))), tag="k4")
    add(launches)
    print(f"[k4] split: converged={sres['converged']} n_iter={sres['n_iter']} "
          f"E={sres['energies']['total']:.12f} E - E_JAX="
          f"{sres['energies']['total'] - r['total_energy']:.3e}", flush=True)
    check(sres["converged"] and abs(sres["energies"]["total"] - r["total_energy"]) < FE_SPLIT_E_TOL,
          f"k4 split SCF converged within {FE_SPLIT_E_TOL} of the JAX energy")
    sd = prepare_split_data(basis)
    U, occ, rho = sres["U"], sres["occupation"], sres["rho"]
    Fs = compute_forces_split(basis, sd, U, occ, rho)
    Ss = compute_stresses_split(basis, sd, U, occ)
    psi, occ_c = split_state_to_complex(basis, U, occ)
    state = types.SimpleNamespace(psi=psi, occupation=occ_c, rho=rho)
    dFc = float((Fs - dt.compute_forces(state, basis)).abs().max())
    dSc = float((Ss - dt.compute_stresses_cart(state, basis)).abs().max())
    Fs_cart = (Fs @ torch.as_tensor(np.linalg.inv(lattice), device=Fs.device)).cpu().numpy()
    dFs, dSs = np.abs(Fs_cart - F_ref).max(), np.abs(Ss.cpu().numpy() - S_ref).max()
    print(f"[k4] split adapters against the complex path on the same state: forces {dFc:.3e}, "
          f"stresses {dSc:.3e}; against the JAX values: {dFs:.3e}, {dSs:.3e}", flush=True)
    check(dFc < ADAPTER_TOL and dSc < ADAPTER_TOL,
          f"k4: split adapters within {ADAPTER_TOL} of the complex path")
    check(dFs < SPLIT_TOL and dSs < SPLIT_TOL, f"k4: split derivatives within {SPLIT_TOL} of JAX's")
    del sres, basis, sd, U, psi, state
    torch.cuda.empty_cache()

    # k5: ferromagnetic bcc iron, the split CheFSI SCF with the "mixed"
    # filter and AdaptiveBands: Fe16 against the JAX package, then Fe54 (the
    # JAX package's Fe54 is out of a host's reach: PERF.md section 7)
    for label, n, key in (("k5 Fe16", 2, "fe16_split"), ("k5 Fe54", 3, None)):
        lattice, pos = fe_bcc_cell(n)
        model = fe_model(dt, lattice, pos, "PBE")
        t0 = time.time()
        basis = dt.PlaneWaveBasis(model, Ecut=15.0, kgrid=(1, 1, 1), device=device)
        print(f"[k5] {basis}, {model.n_electrons} electrons, set up in "
              f"{time.time() - t0:.2f} s", flush=True)
        time_symmetrizer(basis, label, smi, tag="k5")
        n_bands = FE_SPLIT_N_BANDS[n]
        hold_kernels_at(la, basis, label, n_bands, errs, bf16=True, tag="k5")
        growth = []
        sres, launches = run_on_card(la, f"{label} split CheFSI SCF, {n_bands} bands to start",
                                     smi, lambda: dt.self_consistent_field_split(
            basis, tol=1e-7, maxiter=80, n_bands=n_bands, eigensolver="chefsi",
            chebyshev_degree=10, chefsi_cycles=2, is_converged="density",
            filter_precision="mixed", rho0=dt.guess_density(basis, [4.0] * len(pos)),
            callback=lambda i: growth.append(i["adaptive_bands"])
            if "adaptive_bands" in i else None), tag="k5")
        add(launches)
        E = sres["energies"]["total"]
        magn, n_rho, n_occ = spin_summary(dt, basis, sres["rho"], sres["occupation"])
        print(f"[k5] {label}: converged={sres['converged']} n_iter={sres['n_iter']} E={E:.12f} "
              f"({E / len(pos):.12f} per atom); magnetisation {magn:.6f} ({magn / len(pos):.6f} "
              f"per atom); electrons {n_rho:.12f} in rho, {n_occ:.12f} in the occupations; "
              f"AdaptiveBands grew to {growth}, {sres['occupation'].shape[1]} bands", flush=True)
        check(sres["converged"] and np.isfinite(E), f"{label}: converged")
        check(abs(n_occ - model.n_electrons) < N_ELECTRONS_TOL,
              f"{label}: electron count within {N_ELECTRONS_TOL}")
        check(all(v > 0 for v in launches.values()), f"{label}: every kernel launched")
        if key is not None:
            dE = E - ref[key]["total_energy"]
            print(f"[k5] {label}: E - E_JAX={dE:.3e} (JAX magnetisation "
                  f"{ref[key]['magnetisation']:.6f})", flush=True)
            check(abs(dE) < FE_SPLIT_E_TOL, f"{label}: |E - E_JAX| < {FE_SPLIT_E_TOL}")
        del sres, basis
        torch.cuda.empty_cache()
    print(f"[k] phase k took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


# phase l: UPF, NLCC and meta-GGA; the cells of tests/data/make_torch_port_mgga.py,
# whose values (the JAX package's CPU float64 ones, and DFTK's SCAN silicon
# golden) are in tests/data/torch_port_mgga.json
SI_KPOINTS = ([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0], [-1 / 3, 1 / 3, 0]],
              [1 / 27, 8 / 27, 6 / 27, 12 / 27])
C_LATTICE = 6.74 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
C_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
C_DISPLACED = [np.array([0.128, 0.124, 0.122]), -np.ones(3) / 8]
C_UPF = os.path.join("tests", "data", "pseudos", "C_m.upf")
SI_UPF = os.path.join("tests", "data", "pseudos", "gth", "Si.pbe-hgh.upf")
MGGA_E_TOL, SCAN_GOLDEN_TOL, UPF_HGH_TOL = 1e-8, 5e-5, 5e-4
TB09_LOOPS_TOL, TB09_EIG_TOL = 5e-7, 1e-8
# Si54 SCAN: the LOBPCG and split SCFs agree (no JAX value at that size:
# PERF.md section 7); the all-bf16 filter's residual floor, per atom, from
# the CPU measurement written in PERF.md section 6 before the card's run;
# the sphere filter against phase c's compact one on the same LDA problem
SI54_LOOPS_TOL, DEFAULT_FILTER_TOL_PER_ATOM, SPHERE_COMPACT_TOL = 1e-7, 1e-4, 1e-9


def l_silicon(dt, psp, functionals, Ecut, fft, kgrid, device):
    Si = dt.ElementPsp.from_symbol("Si", psp=os.path.join(HERE, psp) if psp.endswith(".upf")
                                   else psp)
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
    model = dt.model_DFT(lattice, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=functionals)
    return dt.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, fft_size=(fft,) * 3, device=device)


def l_carbon(dt, positions, device):
    C = dt.ElementPsp.from_symbol("C", psp=os.path.join(HERE, C_UPF))
    model = dt.model_DFT(C_LATTICE, [C, C], positions, functionals="SCAN")
    return dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), fft_size=(18, 18, 18),
                             device=device)


def l_si54(dt, functionals, psp, device):
    """bench.py's Si54 (tools/run_si_big.py::build_bench_basis) with
    another psp and functional."""
    from dftk_tpu_torch.tools.run_si_big import A_PRIM
    lattice = np.array([[0.0, A_PRIM, A_PRIM], [A_PRIM, 0.0, A_PRIM],
                        [A_PRIM, A_PRIM, 0.0]]) * 3
    Si = dt.ElementPsp.from_symbol("Si", psp=psp)
    positions = [(b + np.array([i, j, k])) / 3 for i in range(3) for j in range(3)
                 for k in range(3) for b in (np.ones(3) / 8, -np.ones(3) / 8)]
    model = dt.model_DFT(lattice, [Si] * len(positions), positions, functionals=functionals,
                         symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)


def mgga_phase(dt, la, device, smi, E_c):
    """Phase l: UPF pseudopotentials, NLCC and meta-GGA on the card: DFTK's
    SCAN silicon golden, silicon from a UPF file and under TPSS, r2SCAN and
    TB09, SCAN + NLCC diamond (both SCF loops, forces and stresses), and
    Si54 under SCAN through LOBPCG and the split SCF with the "mixed" and
    the all-bf16 ("default") sphere filter, and Si54 LDA with the compact
    and the sphere filter in turn against phase c's energy (E_c).  Returns
    the kernel launches of its runs and each kernel's max_abs_err at each
    run's shapes."""
    import types
    import torch
    from dftk_tpu_torch.ops.forces_split import compute_forces_split
    from dftk_tpu_torch.ops.stresses_split import compute_stresses_split
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_mgga.json")) as f:
        ref = json.load(f)
    total, errs = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def run(label, tag, fn, bf16=False):
        out, launches = run_on_card(la, label, smi, fn, tag=tag)
        if bf16:
            check(launches["pruned_axis_dft[bf16]"] > 0 and launches["local_plane[bf16]"] > 0,
                  f"{label}: every bf16 kernel launched")
        add(launches)
        return out

    def energy_line(label, E, r, n_iter, converged, tol=MGGA_E_TOL):
        dE = E - r["total_energy"]
        print(f"[{label.split()[0]}] {label}: converged={converged} n_iter={n_iter} E={E:.12f} "
              f"E - E_JAX={dE:.3e} ({smi})", flush=True)
        check(converged and np.isfinite(E), f"{label}: converged to a finite energy")
        check(abs(dE) < tol, f"{label}: |E - E_JAX| < {tol}")

    # l1: DFTK's SCAN silicon golden (test/silicon_scan.jl), LOBPCG
    r = ref["silicon_scan_golden"]
    basis = l_silicon(dt, "pbe/si-q4", "SCAN", 15.0, 27, dt.ExplicitKpoints(*SI_KPOINTS),
                      device)
    print(f"[l1] SCAN silicon golden: {basis}", flush=True)
    hold_kernels_at(la, basis, "l1", 8, errs, tag="l1")
    hold_kernels_at(la, basis, "l1 DivAgrad", 8, errs, tag="l1", stack=3)
    res = run("l1 SCAN golden LOBPCG SCF", "l1", lambda: dt.self_consistent_field(
        basis, tol=1e-9, is_converged="energy", maxiter=40, n_bands=8))
    energy_line("l1 SCAN golden", res.total_energy, r, res.n_iter, res.converged)
    dev = np.abs(res.eigenvalues[0][:8] - np.array(r["golden"]["eigenvalues_k0"])).max()
    dg = res.total_energy - r["golden"]["total_energy"]
    print(f"[l1] E - E_DFTK={dg:.3e}, max|k=0 eigenvalue - DFTK|={dev:.3e}", flush=True)
    check(abs(dg) < SCAN_GOLDEN_TOL and dev < SCAN_GOLDEN_TOL,
          f"l1: energy and k = 0 eigenvalues within {SCAN_GOLDEN_TOL} of DFTK's SCAN golden")
    del res, basis

    # l2: silicon from the GTH UPF file (PBE), TPSS, r2SCAN; TB09 in both loops
    for key, psp, fun in (("si_upf_pbe", SI_UPF, "PBE"), ("si_tpss", "pbe/si-q4", "TPSS"),
                          ("si_r2scan", "pbe/si-q4", "r2SCAN")):
        basis = l_silicon(dt, psp, fun, 7.0, 17, dt.ExplicitKpoints(*SI_KPOINTS), device)
        label = f"l2 {key}"
        hold_kernels_at(la, basis, label, basis.model.default_n_bands(), errs, tag="l2")
        if fun != "PBE":
            hold_kernels_at(la, basis, f"{label} DivAgrad", basis.model.default_n_bands(), errs,
                            tag="l2", stack=3)
        res = run(f"{label} LOBPCG SCF", "l2",
                  lambda: dt.self_consistent_field(basis, tol=1e-10, maxiter=60))
        energy_line(label, res.total_energy, ref[key], res.n_iter, res.converged)
        if key == "si_upf_pbe":
            dh = res.total_energy - ref["si_hgh_pbe"]["total_energy"]
            print(f"[l2] UPF against the HGH table: E - E_JAX(HGH)={dh:.3e}", flush=True)
            check(abs(dh) < UPF_HGH_TOL, f"l2: UPF within {UPF_HGH_TOL} of the HGH run")
        del res, basis
    r = ref["si_tb09"]
    basis = l_silicon(dt, "lda/si-q4", "TB09", 8.0, 18, (2, 2, 2), device)
    hold_kernels_at(la, basis, "l2 TB09", 6, errs, tag="l2")
    res = run("l2 TB09 LOBPCG SCF", "l2", lambda: dt.self_consistent_field(
        basis, tol=1e-9, maxiter=60, n_bands=6, is_converged="density"))
    sres = run("l2 TB09 split SCF", "l2", lambda: dt.self_consistent_field_split(
        basis, tol=1e-9, maxiter=100, n_bands=6, eigensolver="lobpcg", is_converged="density",
        diagtol_min=1e-11))
    ev, evs = np.sort(res.eigenvalues[:, :6], axis=1), sres["eigenvalues"][:, :6]
    d_loops = np.abs(ev - evs).max()
    d_jax = max(np.abs(ev - np.sort(np.array(r["eigenvalues"])[:, :6], axis=1)).max(),
                np.abs(evs - np.array(r["split"]["eigenvalues"])[:, :6]).max())
    print(f"[l2] TB09: converged {res.converged} ({res.n_iter} iterations) and "
          f"{sres['converged']} ({sres['n_iter']}); the loops' eigenvalues {d_loops:.3e} apart, "
          f"{d_jax:.3e} from the JAX package's ({smi})", flush=True)
    check(res.converged and sres["converged"], "l2 TB09: both loops converged")
    check(d_loops < TB09_LOOPS_TOL and d_jax < TB09_EIG_TOL,
          f"l2 TB09: loops within {TB09_LOOPS_TOL}, eigenvalues within {TB09_EIG_TOL} of JAX")
    del res, sres, basis

    # l3: SCAN + NLCC diamond (C_m.upf): both loops, then the displaced cell's
    # forces and stresses
    r = ref["c2_scan_nlcc"]
    basis = l_carbon(dt, C_POSITIONS, device)
    print(f"[l3] C2 SCAN + NLCC: {basis}", flush=True)
    hold_kernels_at(la, basis, "l3", 4, errs, bf16=True, tag="l3")
    hold_kernels_at(la, basis, "l3 DivAgrad", 4, errs, bf16=True, tag="l3", stack=3)
    res = run("l3 C2 LOBPCG SCF", "l3",
              lambda: dt.self_consistent_field(basis, tol=1e-10, maxiter=80))
    energy_line("l3 C2 LOBPCG", res.total_energy, r, res.n_iter, res.converged)
    sres = run("l3 C2 split CheFSI SCF (sphere filter, mixed)", "l3",
               lambda: dt.self_consistent_field_split(
                   basis, tol=1e-10, maxiter=100, eigensolver="chefsi", chebyshev_degree=10,
                   chefsi_cycles=2, is_converged="density", filter_precision="mixed"),
               bf16=True)
    energy_line("l3 C2 split", sres["energies"]["total"], r["split"], sres["n_iter"],
                sres["converged"])
    del res, sres, basis
    r = ref["c2_scan_nlcc_derivatives"]
    agree = r["two_runs_agree"]
    basis = l_carbon(dt, C_DISPLACED, device)
    print(f"[l3] displaced C2: {basis}; two JAX SCFs agree to {agree['forces']:.1e} Ha/bohr, "
          f"{agree['stresses']:.1e} Ha/bohr^3", flush=True)
    check(agree["forces"] < FORCE_TOL / 10 and agree["stresses"] < STRESS_TOL / 10,
          "l3: two JAX SCFs agree well inside the bars")
    res = run("l3 displaced C2 LOBPCG SCF", "l3",
              lambda: dt.self_consistent_field(basis, tol=1e-11, maxiter=80))
    energy_line("l3 displaced C2", res.total_energy, r, res.n_iter, res.converged)
    F, F_ms, F_mib = timed_on_card(lambda: dt.compute_forces_cart(res))
    S, S_ms, S_mib = timed_on_card(lambda: dt.compute_stresses_cart(res))
    dF = np.abs(F.cpu().numpy() - np.array(r["forces_cart"])).max()
    dS = np.abs(S.cpu().numpy() - np.array(r["stresses_cart"])).max()
    print(f"[l3] forces {F_ms[0]:.1f} ms (again {F_ms[1]:.1f}), peak {F_mib:.1f} MiB, "
          f"max|F - F_JAX|={dF:.3e}; stresses {S_ms[0]:.1f} ms (again {S_ms[1]:.1f}), peak "
          f"{S_mib:.1f} MiB, max|S - S_JAX|={dS:.3e} ({smi})", flush=True)
    check(F.device.type == "cuda" and dF < FORCE_TOL and dS < STRESS_TOL,
          f"l3: forces within {FORCE_TOL}, stresses within {STRESS_TOL} of the JAX package's")
    U = torch.cat([res.psi.real, res.psi.imag], dim=-1)
    occ = torch.as_tensor(res.occupation, device=basis.device)
    state = types.SimpleNamespace(psi=res.psi, occupation=occ, rho=res.rho)
    dFc = float((compute_forces_split(basis, None, U, occ, res.rho)
                 - dt.compute_forces(state, basis)).abs().max())
    dSc = float((compute_stresses_split(basis, None, U, occ)
                 - dt.compute_stresses_cart(state, basis)).abs().max())
    print(f"[l3] split adapters (tau from the orbitals) against the complex path: forces "
          f"{dFc:.3e}, stresses {dSc:.3e}", flush=True)
    check(dFc < ADAPTER_TOL and dSc < ADAPTER_TOL, f"l3: split adapters within {ADAPTER_TOL}")
    del res, basis, state, U
    torch.cuda.empty_cache()

    # l4: Si54 under SCAN (bench.py's cell, pbe/si-q4): LOBPCG, the split SCF
    # with the "mixed" sphere filter and with the all-bf16 one; then phase c's
    # LDA Si54 with the sphere filter
    t0 = time.time()
    basis = l_si54(dt, "SCAN", "pbe/si-q4", device)
    n_bands = basis.model.default_n_bands()
    print(f"[l4] Si54 SCAN: {basis}, set up in {time.time() - t0:.2f} s", flush=True)
    hold_kernels_at(la, basis, "l4", n_bands, errs, bf16=True, tag="l4")
    hold_kernels_at(la, basis, "l4 DivAgrad", n_bands, errs, bf16=True, tag="l4", stack=3)

    def show(tag):
        return lambda i: print(f"[{tag}] it={i['n_iter']:3d} E={i['E']:.12f} "
                               f"drho={i['drho']:.3e}", flush=True) if "E" in i else None

    res = run("l4 Si54 SCAN LOBPCG SCF", "l4", lambda: dt.self_consistent_field(
        basis, tol=1e-8, maxiter=60, callback=show("l4 LOBPCG")))
    E_lobpcg = res.total_energy
    print(f"[l4] LOBPCG: converged={res.converged} n_iter={res.n_iter} E={E_lobpcg:.12f}",
          flush=True)
    check(res.converged and np.isfinite(E_lobpcg), "l4 LOBPCG: converged")
    del res
    split = dict(eigensolver="chefsi", chebyshev_degree=10, chefsi_cycles=2,
                 is_converged="density")
    sres = run("l4 Si54 SCAN split SCF, mixed", "l4", lambda: dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=60, filter_precision="mixed", callback=show("l4 mixed"),
        **split), bf16=True)
    E_mixed = sres["energies"]["total"]
    print(f"[l4] mixed: converged={sres['converged']} n_iter={sres['n_iter']} E={E_mixed:.12f} "
          f"E - E_LOBPCG={E_mixed - E_lobpcg:.3e}", flush=True)
    check(sres["converged"] and abs(E_mixed - E_lobpcg) < SI54_LOOPS_TOL,
          f"l4: the split SCF within {SI54_LOOPS_TOL} of LOBPCG")
    del sres
    sres = run("l4 Si54 SCAN split SCF, default", "l4", lambda: dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=15, filter_precision="default", callback=show("l4 default"),
        **split), bf16=True)
    E_default = sres["energies"]["total"]
    bar = DEFAULT_FILTER_TOL_PER_ATOM * len(basis.model.atoms)
    print(f"[l4] default: n_iter={sres['n_iter']} E={E_default:.12f} E - E_mixed="
          f"{E_default - E_mixed:.3e} (bar {bar:.1e}); best density residual "
          f"{min(h[1] for h in sres['history']):.3e}", flush=True)
    check(np.isfinite(E_default) and abs(E_default - E_mixed) < bar,
          f"l4: the all-bf16 filter within {bar:.1e} of the mixed run")
    del sres, basis
    torch.cuda.empty_cache()
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    basis = build_bench_basis(3, 10.0, device)
    # the two filters on the same LDA problem, timed in turn: compact,
    # sphere, compact, sphere
    walls = {True: [], False: []}
    for compact in (True, False, True, False):
        name = "compact" if compact else "sphere"
        t0 = time.time()
        sres = run(f"l4 Si54 LDA split SCF, {name} filter", "l4",
                   lambda: dt.self_consistent_field_split(
                       basis, tol=1e-8, maxiter=60, filter_precision="mixed",
                       compact_filter=compact, **split), bf16=True)
        walls[compact].append((time.time() - t0) / sres["n_iter"])
        E = sres["energies"]["total"]
        print(f"[l4] LDA Si54, {name} filter: converged={sres['converged']} "
              f"n_iter={sres['n_iter']} E={E:.12f} E - E_compact(phase c)={E - E_c:.3e}",
              flush=True)
        check(sres["converged"] and abs(E - E_c) < SPHERE_COMPACT_TOL,
              f"l4: the {name} filter within {SPHERE_COMPACT_TOL} of phase c's compact one")
        del sres
    print(f"[l4] LDA Si54 wall per iteration: compact filter "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls[True])} ms, sphere filter "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls[False])} ms; sphere / compact "
          f"{sum(walls[False]) / sum(walls[True]):.3f} ({smi})", flush=True)
    del basis
    torch.cuda.empty_cache()
    print(f"[l] phase l took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


# phase m: the other SCF solvers and the response core; the cells of
# tests/data/make_torch_port_response.py (copied below), whose JAX values are
# in tests/data/torch_port_response.json
AL_FCC = 7.65339 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
HE_BOX = 10.0
CHI0_REL_TOL, CHARGE_TOL, POLARIZABILITY_REL_TOL, DYSON_INEXACT_TOL, GAP_TOL = (
    1e-8, 1e-8, 1e-6, 1e-7, 1e-5)
# Newton's warm start: the LOBPCG SCF's iterations before the first step
NEWTON_START_ITERS = 2
# potential mixing's residual falls slowly and not monotonically: its least
# in 40 iterations on Si8 is 1.97e-6 (the port) and 1.20e-6 (the JAX
# package), CPU, PERF.md section 6.  The run is capped at 40 iterations;
# its energy is gated and its least residual at 10x that Si8 floor
POTENTIAL_MIXING_ITERS = 40
POTENTIAL_MIXING_RESIDUAL_BAR = 2e-5


def smooth_potential(fft_size):
    """The smooth zero-mean dV [1, n1, n2, n3] of tests/test_chi0_metal.py."""
    axes = [np.arange(n) / n for n in fft_size]
    r = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return 0.1 * (np.cos(2 * np.pi * r[..., 0]) + np.sin(2 * np.pi * r[..., 1])
                  + 0.5 * np.cos(2 * np.pi * (r[..., 1] + r[..., 2])))[None]


def solvers_phase(dt, la, device, smi):
    """Phase m: the other ground-state solvers and the response core on the
    card: Si54 (phase 4's basis) by potential mixing, Newton, direct
    minimization and the SCF with Chi0Mixing against E_ref; chi0 of a metal,
    the helium polarizability with exact and inexact GMRES, and the
    lowest eigenvalue of Omega on atomic Si2 against the JAX package's
    values.  Returns the kernel launches of its runs and each kernel's
    max_abs_err at each run's shapes."""
    import torch
    from dftk_tpu_torch.response import chi0 as chi0_mod
    from dftk_tpu_torch.response.hessian import solve_dyson
    from dftk_tpu_torch.scf.newton import newton
    from dftk_tpu_torch.scf.potential_mixing import scf_potential_mixing
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_response.json")) as f:
        ref = json.load(f)
    with open(os.path.join(HERE, "tests", "data", "torch_port_si54.json")) as f:
        E_ref = json.load(f)["total_energy"]
    total, errs = {}, {}
    cg = chi0_mod.counts

    def run(label, tag, fn):
        cg.reset()
        out, launches = run_on_card(la, label, smi, fn, tag=tag)
        print(f"[{tag}] {label}: {cg.solves} Sternheimer solves (chi0 applies: GMRES matvecs "
              f"in Chi0Mixing and the Dyson solve), CG steps {cg.steps}, {cg.host_reads} host "
              f"reads of a residual norm", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    def show(tag):
        return lambda i: print(f"[{tag}] it={i['n_iter']:3d} E={i['E']:.12f} " + " ".join(
            f"{k}={i[k]:.3e}" for k in ("drho", "dV", "rnorm", "gnorm") if k in i), flush=True)

    def energy_line(tag, label, res, bar=E_TOL, converges=True):
        dE = res.total_energy - E_ref
        print(f"[{tag}] {label}: converged={res.converged} n_iter={res.n_iter} "
              f"E={res.total_energy:.12f} E - E_ref={dE:.3e} (bar {bar:.0e}; {smi})", flush=True)
        check(res.converged or not converges, f"{label}: converged")
        check(np.isfinite(res.total_energy) and abs(dE) < bar,
              f"{label}: within {bar} Ha of E_ref")

    # m1: Si54 by potential mixing, Newton and direct minimization
    t0 = time.time()
    basis = build_bench_basis(3, 10.0, device)
    n_bands = basis.model.default_n_bands()
    print(f"[m1] {basis} set up in {time.time() - t0:.1f} s", flush=True)
    hold_kernels_at(la, basis, "m1 potential mixing", n_bands, errs, tag="m1")
    res = run("m1 Si54 potential mixing", "m1", lambda: scf_potential_mixing(
        basis, tol=1e-9, maxiter=POTENTIAL_MIXING_ITERS, callback=show("m1 potential mixing")))
    least = min(res.history_Drho)
    print(f"[m1] potential mixing: residual {res.history_Drho[-1]:.3e}, least {least:.3e} "
          f"(bar {POTENTIAL_MIXING_RESIDUAL_BAR:.0e})", flush=True)
    check(least < POTENTIAL_MIXING_RESIDUAL_BAR,
          f"m1 potential mixing: least residual under {POTENTIAL_MIXING_RESIDUAL_BAR}")
    energy_line("m1", "potential mixing", res, converges=False)
    del res
    hold_kernels_at(la, basis, "m1 Newton warm start", n_bands, errs, tag="m1",
                    block=n_bands + 2)
    hold_kernels_at(la, basis, "m1 Newton", n_bands, errs, tag="m1", block=n_bands)
    res = run("m1 Si54 Newton", "m1", lambda: newton(
        basis, tol=1e-10, scf_start_iters=NEWTON_START_ITERS, callback=show("m1 Newton")))
    energy_line("m1", f"Newton (warm start: {NEWTON_START_ITERS} SCF iterations)", res)
    del res
    hold_kernels_at(la, basis, "m1 direct minimization", n_bands, errs, tag="m1",
                    block=n_bands)
    res = run("m1 Si54 direct minimization", "m1", lambda: dt.direct_minimization(
        basis, tol=1e-11, maxiter=500))
    energy_line("m1", "direct minimization", res)
    del res

    # m2: the LOBPCG SCF with the exact chi0 mixing
    hold_kernels_at(la, basis, "m2 Chi0Mixing", n_bands, errs, tag="m2")
    res = run("m2 Si54 Chi0Mixing SCF", "m2", lambda: dt.self_consistent_field(
        basis, tol=1e-8, maxiter=40, mixing=dt.Chi0Mixing(), callback=show("m2 Chi0Mixing")))
    energy_line("m2", "Chi0Mixing SCF", res)
    del res, basis
    torch.cuda.empty_cache()

    # m3: the response operators against the JAX package's values
    r = ref["al_chi0"]
    Al = dt.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dt.model_DFT(AL_FCC, [Al], [np.zeros(3)], functionals=["lda_x", "lda_c_vwn"],
                         temperature=1e-2, symmetries=False)
    basis = dt.PlaneWaveBasis(model, Ecut=6.0, kgrid=(3, 3, 3), device=device)
    check(list(basis.fft_size) == r["fft_size"], "m3 Al: the JAX package's FFT size")
    hold_kernels_at(la, basis, "m3 Al", 8, errs, tag="m3", block=12)
    res = run("m3 Al SCF", "m3", lambda: dt.self_consistent_field(
        basis, tol=1e-11, maxiter=60, n_bands=8, n_extra_bands=4))
    print(f"[m3] Al: n_iter={res.n_iter} E - E_JAX={res.total_energy - r['total_energy']:.3e}",
          flush=True)
    ctx = dt.make_chi0_context(res)
    dV = basis.tensor(smooth_potential(basis.fft_size))
    for key, schur in (("schur", True), ("plain", False)):
        drho = run(f"m3 Al chi0 dV ({key})", "m3",
                   lambda: dt.apply_chi0(ctx, basis, dV, tol=1e-11, use_schur=schur))
        want = np.array(r[f"chi0_{key}"])
        rel = float(np.abs(drho.cpu().numpy() - want).max() / np.abs(want).max())
        charge = float(drho.sum()) * basis.dvol
        print(f"[m3] Al chi0 dV ({key}): relative to the JAX package's {rel:.3e} (bar "
              f"{CHI0_REL_TOL:.0e}), charge {charge:.2e} ({smi})", flush=True)
        check(rel < CHI0_REL_TOL and abs(charge) < CHARGE_TOL,
              f"m3 Al chi0 ({key}) within {CHI0_REL_TOL} of JAX, charge conserved")
    del res, ctx, basis

    r = ref["helium"]
    He = dt.ElementPsp.from_symbol("He", psp="lda/he-q2")
    model = dt.model_DFT(np.eye(3) * HE_BOX, [He], [np.array([0.5, 0.5, 0.5])],
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    basis = dt.PlaneWaveBasis(model, Ecut=8.0, kgrid=(1, 1, 1), device=device)
    check(list(basis.fft_size) == r["fft_size"], "m3 He: the JAX package's FFT size")
    hold_kernels_at(la, basis, "m3 He", 1, errs, tag="m3", block=4)
    res = run("m3 He SCF", "m3", lambda: dt.self_consistent_field(basis, tol=1e-11, maxiter=60))
    alpha = run("m3 He polarizability", "m3",
                lambda: dt.compute_polarizability(res, direction=2, tol=1e-9))
    rel = abs(alpha - r["polarizability"]) / abs(r["polarizability"])
    print(f"[m3] He polarizability {alpha:.10f}, JAX {r['polarizability']:.10f}: relative "
          f"{rel:.3e} (bar {POLARIZABILITY_REL_TOL:.0e})", flush=True)
    check(rel < POLARIZABILITY_REL_TOL, f"m3 He polarizability within {POLARIZABILITY_REL_TOL}")
    axes = [np.arange(n) / n for n in basis.fft_size]
    z = np.meshgrid(*axes, indexing="ij")[2] * HE_BOX - HE_BOX / 2
    dV = basis.tensor(z[None])
    exact, inexact = (run(f"m3 He Dyson, {name} GMRES", "m3",
                          lambda: solve_dyson(res, dV, tol=1e-8, inexact=flag)[0])
                      for name, flag in (("exact", False), ("inexact", True)))
    diff = float((exact - inexact).abs().max())
    print(f"[m3] He Dyson drho, inexact against exact: {diff:.3e} (bar {DYSON_INEXACT_TOL:.0e})",
          flush=True)
    check(diff < DYSON_INEXACT_TOL, f"m3 inexact GMRES within {DYSON_INEXACT_TOL} of exact")
    del res, basis, exact, inexact

    r = ref["si2_atomic"]
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
    model = dt.model_atomic(lattice, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8])
    basis = dt.PlaneWaveBasis(model, Ecut=5.0, kgrid=(1, 1, 1), device=device)
    hold_kernels_at(la, basis, "m3 atomic Si2", 6, errs, tag="m3")
    hold_kernels_at(la, basis, "m3 atomic Si2 Omega", 6, errs, tag="m3", block=4)
    res = run("m3 atomic Si2 SCF", "m3",
              lambda: dt.self_consistent_field(basis, tol=1e-8, n_bands=6))
    gap = float(res.eigenvalues[0, 4] - res.eigenvalues[0, 3])
    lam, _ = run("m3 atomic Si2 eigen_omega_plus_k", "m3", lambda: dt.eigen_omega_plus_k(
        basis, res.psi[:, :4], torch.as_tensor(res.occupation[:, :4], device=device),
        n_eigs=3, include_K=False, tol=1e-8))
    print(f"[m3] atomic Si2: lowest eigenvalue of Omega {lam[0]:.10f}, gap {gap:.10f}, "
          f"difference {lam[0] - gap:.3e} (bar {GAP_TOL:.0e}); JAX "
          f"{r['omega_eigenvalues'][0]:.10f}, gap {r['gap']:.10f}", flush=True)
    check(abs(lam[0] - gap) < GAP_TOL,
          f"m3 lowest eigenvalue of Omega within {GAP_TOL} of the gap")
    del res, basis
    torch.cuda.empty_cache()
    print(f"[m] phase m took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


# phase n: Gamma phonons and the elastic response; the cells of
# tests/data/make_torch_port_phonon.py (copied: this script imports nothing
# of tests/), its JAX values in tests/data/torch_port_phonon.json
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
MG_LATTICE = np.array([[-3.0179389206, -3.0179389206, 0.0],
                       [-5.2272235447, 5.2272235447, 0.0],
                       [0.0, 0.0, -9.7736219469]]).T
MG_POSITIONS = [np.array([2 / 3, 1 / 3, 1 / 4]), np.array([1 / 3, 2 / 3, 3 / 4])]
SI_FULL_WIDTH = dict(Ecut=15.0, kgrid=(4, 4, 4))
DFPT_TOLS = dict(tol=1e-8, sternheimer_tol=1e-11)    # tests/test_dfpt_phonon.py's FD check
FD_DELTA, FD_SCF_TOL, FD_STRAIN = 1e-3, 1e-11, 1e-4
DYNMAT_FD_BAR, FREQ_RTOL = 1e-6, 1e-5    # Ha/bohr^2 absolute; the optical frequencies
ELASTIC_FD_BAR = 1e-4                    # Ha/bohr^3 on columns 0 and 3
MG_FD_REL_BAR, AL_FD_BAR = 5e-4, 1e-5    # the reference's slow tests
# against the JAX package's value, from the port's own SCF to 1e-12: silicon,
# and the metals (their Fermi level moves the response more)
JAX_REL_BAR, JAX_METAL_REL_BAR = 1e-9, 1e-8
ACOUSTIC_CM1, OPTICAL_SPLIT = 0.5, 1e-4


def si2_phonon_basis(dt, device, Ecut, kgrid, fft_size=None, positions=None, lattice=None,
                     **kw):
    """Silicon (lda/si-q4, LDA) at A_SI's fcc lattice, or at `lattice` with
    no symmetry (the strained cells of the finite differences)."""
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE if lattice is None else lattice, [Si, Si],
                         positions or SI_POSITIONS, functionals=["lda_x", "lda_c_vwn"],
                         **({} if lattice is None else dict(symmetries=False)), **kw)
    return dt.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, fft_size=fft_size, device=device)


def mg_phonon_basis(dt, device, positions=None):
    Mg = dt.ElementPsp.from_symbol("Mg", psp="lda/mg-q2")
    model = dt.model_DFT(MG_LATTICE, [Mg, Mg], positions or MG_POSITIONS,
                         functionals=["lda_x", "lda_c_vwn"], temperature=0.01)
    return dt.PlaneWaveBasis(model, Ecut=5.0, kgrid=(2, 2, 2), device=device)


def al_elastic_basis(dt, device, lattice=AL_FCC):
    Al = dt.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dt.model_DFT(lattice, [Al], [np.zeros(3)], functionals=["lda_x", "lda_c_vwn"],
                         temperature=1e-2, symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=6.0, kgrid=(3, 3, 3), fft_size=(15, 15, 15),
                             device=device)


def c2_upf_basis(dt, device, lattice=None, fft_size=None):
    """Diamond C2 from C_m.upf under LDA, Ecut 7, Gamma, the default FFT
    size; at `lattice` with no symmetry and the unstrained cell's FFT size
    (the strained cells, whose default size is 15^3, not 16^3)."""
    C = dt.ElementPsp.from_symbol("C", psp=os.path.join(HERE, C_UPF))
    model = dt.model_DFT(C_LATTICE if lattice is None else lattice, [C, C], C_POSITIONS,
                         functionals=["lda_x", "lda_c_vwn"],
                         **({} if lattice is None else dict(symmetries=False)))
    return dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=(1, 1, 1), fft_size=fft_size, device=device)


def counted_run(la, smi, total, label, tag, fn):
    """run_on_card with the response loops' counts (chi0.counts) set to 0
    just before fn and printed after it; adds its launches to total."""
    from dftk_tpu_torch.response import chi0 as chi0_mod
    cg = chi0_mod.counts
    cg.reset()
    out, launches = run_on_card(la, label, smi, fn, tag=tag)
    print(f"[{tag}] {label}: {cg.solves} Sternheimer solves, CG steps {cg.steps}, "
          f"{cg.host_reads} host reads of a residual norm", flush=True)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return out


def held_against(smi, tag, label, C, want, bar, scale=None):
    """max|C - want| against bar (absolute, or relative to max|want| where
    scale is given)."""
    C, want = np.asarray(C), np.asarray(want)
    diff, peak = float(np.abs(C - want).max()), float(np.abs(want).max())
    print(f"[{tag}] {label}: max diff {diff:.3e}, relative {diff / max(peak, 1e-300):.3e}"
          f" (bar {bar:.0e}{' of max' if scale else ''}; {smi})", flush=True)
    check(np.isfinite(C).all() and C.shape == want.shape
          and diff < bar * (peak if scale else 1.0), f"{label} within {bar}")


def phonon_phase(dt, la, device, smi):
    """Phase n: Gamma-point DFPT phonons and the elastic response on the card.
    n1: silicon at full width (symmetric, unfolded by the DFPT and elastic
    entry points): dynmat_dfpt_gamma and its modes against the finite-
    difference dynamical matrix, elastic_tensor_response against the
    finite-difference elastic_tensor (columns 0 and 3), both also against
    the JAX package's values; n2: magnesium's
    DFPT and aluminium's elastic response against their finite differences
    and the JAX package's values; n3: the reference-size silicon dynmat
    against the JAX package's, and diamond's elastic response from the UPF
    file C_m.upf against the JAX package's and its finite differences.
    Returns the kernel launches of its runs and
    each kernel's max_abs_err at each run's shapes."""
    import torch
    from dftk_tpu_torch.postprocess.elastic import elastic_tensor
    from dftk_tpu_torch.postprocess.phonon import (HARTREE_TO_CM1, compute_dynmat_finite_diff,
                                                   phonon_modes_from_dynmat)
    from dftk_tpu_torch.response.phonon_dfpt import dynmat_dfpt_gamma
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_phonon.json")) as f:
        ref = json.load(f)
    total, errs = {}, {}

    def run(label, tag, fn):
        return counted_run(la, smi, total, label, tag, fn)

    def against(tag, label, C, want, bar, scale=None):
        held_against(smi, tag, label, C, want, bar, scale)

    def modes(tag, label, C, atoms):
        f, _ = phonon_modes_from_dynmat(C, atoms)
        acoustic, split = np.abs(f[:3]).max() * HARTREE_TO_CM1, abs(f[5] - f[3]) / f[3]
        print(f"[{tag}] {label} frequencies (cm^-1): {np.round(f * HARTREE_TO_CM1, 4).tolist()}; "
              f"acoustic {acoustic:.2e}, optical split {split:.1e}", flush=True)
        return f, acoustic, split

    # n1: silicon at full width, with its finite differences
    basis = si2_phonon_basis(dt, device, **SI_FULL_WIDTH)
    print(f"[n1] {basis}", flush=True)
    hold_kernels_at(la, basis, "n1 SCF", 4, errs, tag="n1")
    res = run("n1 Si2 SCF", "n1", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=60))
    ub = dt.unfold_bz(res).basis
    check(ub.n_kpoints == int(np.prod(SI_FULL_WIDTH["kgrid"])), "n1 unfolded onto the full grid")
    hold_kernels_at(la, ub, "n1 DFPT", 4, errs, tag="n1")
    C = run("n1 DFPT dynmat", "n1", lambda: dynmat_dfpt_gamma(res, **DFPT_TOLS))
    f, acoustic, split = modes("n1", "DFPT", C, basis.model.atoms)
    check(acoustic < ACOUSTIC_CM1 and f[3] > 0 and split < OPTICAL_SPLIT,
          "n1 acoustic sum rule and threefold optical mode")
    hold_kernels_at(la, ub, "n1 elastic", 4, errs, tag="n1", block=4)
    C_el = run("n1 elastic response", "n1", lambda: dt.elastic_tensor_response(res))
    print(f"[n1] elastic response (Ha/bohr^3): C11 {C_el[0, 0]:.10f} C12 {C_el[0, 1]:.10f} "
          f"C44 {C_el[3, 3]:.10f}", flush=True)
    check(abs(C_el[0, 0] - C_el[1, 1]) < 1e-8 and abs(C_el[0, 1] - C_el[0, 2]) < 1e-8
          and abs(C_el[3, 3] - C_el[4, 4]) < 1e-8 and np.abs(C_el[:3, 3:]).max() < 1e-7
          and C_el[0, 0] > C_el[0, 1] > 0 and C_el[3, 3] > 0, "n1 cubic elastic tensor")
    r = ref["si2_full_width"]
    against("n1", "DFPT dynmat against the JAX package's", C, r["dynmat"], JAX_REL_BAR,
            scale=True)
    against("n1", "elastic response against the JAX package's", C_el, r["elastic"],
            JAX_REL_BAR, scale=True)
    del res

    displaced = [SI_POSITIONS[0] + np.linalg.solve(SI_LATTICE, [FD_DELTA, 0, 0]),
                 SI_POSITIONS[1]]
    hold_kernels_at(la, si2_phonon_basis(dt, device, **SI_FULL_WIDTH, positions=displaced),
                    "n1 FD dynmat", 4, errs, tag="n1")
    C_fd = run("n1 FD dynmat (12 SCFs)", "n1", lambda: compute_dynmat_finite_diff(
        lambda pos: si2_phonon_basis(dt, device, **SI_FULL_WIDTH, positions=pos), SI_POSITIONS,
        scf_kwargs=dict(tol=FD_SCF_TOL), delta=FD_DELTA))
    against("n1", "DFPT dynmat against finite differences", C, C_fd, DYNMAT_FD_BAR)
    f_fd, _ = phonon_modes_from_dynmat(C_fd, basis.model.atoms)
    rdiff = float(np.abs(f[3:] / f_fd[3:] - 1).max())
    print(f"[n1] optical frequencies, DFPT against FD: relative {rdiff:.3e} (bar "
          f"{FREQ_RTOL:.0e})", flush=True)
    check(rdiff < FREQ_RTOL, f"n1 optical frequencies within {FREQ_RTOL} of FD")

    def strained_basis(L):
        return si2_phonon_basis(dt, device, **SI_FULL_WIDTH, fft_size=basis.fft_size,
                                lattice=L)

    hold_kernels_at(la, strained_basis(SI_LATTICE), "n1 FD elastic", 4, errs, tag="n1")
    C_el_fd = run("n1 FD elastic tensor (4 SCFs)", "n1", lambda: elastic_tensor(
        strained_basis, SI_LATTICE, scf_kwargs=dict(tol=1e-12), eps=FD_STRAIN,
        components=[0, 3]))
    against("n1", "elastic response against finite differences (columns 0, 3)",
            C_el[:, [0, 3]], C_el_fd[:, [0, 3]], ELASTIC_FD_BAR)
    del basis
    torch.cuda.empty_cache()

    # n2: the metals against their finite differences and the JAX package
    basis = mg_phonon_basis(dt, device)
    mg_kw = dict(n_bands=6, n_extra_bands=4)
    hold_kernels_at(la, basis, "n2 Mg", 6, errs, tag="n2", block=10)
    res = run("n2 Mg SCF", "n2", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=80,
                                                                  **mg_kw))
    C = run("n2 Mg DFPT dynmat", "n2", lambda: dynmat_dfpt_gamma(res, **DFPT_TOLS))
    C_fd = run("n2 Mg FD dynmat (12 SCFs)", "n2", lambda: compute_dynmat_finite_diff(
        lambda pos: mg_phonon_basis(dt, device, pos), MG_POSITIONS,
        scf_kwargs=dict(tol=FD_SCF_TOL, **mg_kw), delta=FD_DELTA))
    against("n2", "Mg DFPT dynmat against finite differences", C, C_fd, MG_FD_REL_BAR,
            scale=True)
    against("n2", "Mg DFPT dynmat against the JAX package's", C, ref["mg_dfpt"]["dynmat"],
            JAX_METAL_REL_BAR, scale=True)
    del res, basis
    basis = al_elastic_basis(dt, device)
    hold_kernels_at(la, basis, "n2 Al", 6, errs, tag="n2", block=10)
    res = run("n2 Al SCF", "n2", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=80,
                                                                  **mg_kw))
    C_el = run("n2 Al elastic response", "n2", lambda: dt.elastic_tensor_response(res))
    C_el_fd = run("n2 Al FD elastic tensor (4 SCFs)", "n2", lambda: elastic_tensor(
        lambda L: al_elastic_basis(dt, device, L), AL_FCC,
        scf_kwargs=dict(tol=1e-12, maxiter=80, **mg_kw), eps=FD_STRAIN, components=[0, 3]))
    against("n2", "Al elastic response against finite differences (columns 0, 3)",
            C_el[:, [0, 3]], C_el_fd[:, [0, 3]], AL_FD_BAR)
    against("n2", "Al elastic response against the JAX package's", C_el,
            ref["al_elastic"]["elastic"], JAX_METAL_REL_BAR, scale=True)
    del res, basis
    torch.cuda.empty_cache()

    # n3: the reference-size silicon dynmat against the JAX package's
    r = ref["si2_reference_dynmat"]
    basis = si2_phonon_basis(dt, device, Ecut=6.0, kgrid=(2, 2, 2))
    check(list(basis.fft_size) == r["fft_size"], "n3 Si2: the JAX package's FFT size")
    hold_kernels_at(la, basis, "n3 Si2", 4, errs, tag="n3")
    res = run("n3 Si2 SCF", "n3", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=60))
    C = run("n3 Si2 DFPT dynmat", "n3", lambda: dynmat_dfpt_gamma(res, **DFPT_TOLS))
    against("n3", "Si2 DFPT dynmat against the JAX package's", C, r["dynmat"],
            JAX_REL_BAR, scale=True)
    del res, basis
    # n3: a UPF model's elastic response (the form factors' curvature)
    # against the JAX package's and its finite differences
    basis = c2_upf_basis(dt, device)
    check(list(basis.fft_size) == ref["c2_upf"]["fft_size"], "n3 C2: the JAX package's FFT size")
    hold_kernels_at(la, basis, "n3 C2 UPF", 4, errs, tag="n3")
    res = run("n3 C2 UPF SCF", "n3", lambda: dt.self_consistent_field(basis, tol=1e-12,
                                                                      maxiter=60))
    C_el = run("n3 C2 UPF elastic response", "n3", lambda: dt.elastic_tensor_response(res))
    against("n3", "C2 UPF elastic response against the JAX package's", C_el,
            ref["c2_upf"]["elastic"], JAX_REL_BAR, scale=True)
    C_el_fd = run("n3 C2 UPF FD elastic tensor (4 SCFs)", "n3", lambda: elastic_tensor(
        lambda L: c2_upf_basis(dt, device, L, basis.fft_size), C_LATTICE,
        scf_kwargs=dict(tol=1e-12), eps=FD_STRAIN, components=[0, 3]))
    against("n3", "C2 UPF elastic response against finite differences (columns 0, 3)",
            C_el[:, [0, 3]], C_el_fd[:, [0, 3]], ELASTIC_FD_BAR)
    del res, basis
    torch.cuda.empty_cache()
    print(f"[n] phase n took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


# phase o: phonons at q, the supercell force constants and the split
# response adapters; the cells of tests/data/make_torch_port_phonon_q.py
# and tests/test_phonon_q.py (copied), the JAX values in
# tests/data/torch_port_phonon_q.json
Q_X, Q_QUARTER = [0.5, 0.0, 0.0], [0.25, 0.0, 0.0]
# the IFC route of tests/test_phonon_q.py's slow tests: silicon's (2, 1, 1)
# supercell on kgrid (2, 4, 4), the same k-points as 4^3, and magnesium's on
# (1, 2, 2) with 12 + 6 bands; DFPT frequencies against it at X
IFC_SI = dict(supercell_size=(2, 1, 1), kgrid=(2, 4, 4), scf_kwargs=dict(tol=1e-11),
              delta=2e-2)
IFC_MG = dict(supercell_size=(2, 1, 1), kgrid=(1, 2, 2),
              scf_kwargs=dict(tol=1e-11, n_bands=12, n_extra_bands=6), delta=2e-2)
IFC_SI_BAR, IFC_MG_BAR = 1e-5, 2e-5          # Ha, tests/test_phonon_q.py:145, :169
# tests/test_phonon_q.py: q = 0 against the Gamma code (real, imaginary
# parts), time reversal; the si_fc fixture and the Ewald fold
GAMMA_Q_BAR, GAMMA_Q_IMAG_BAR, TIME_REVERSAL_BAR = 1e-9, 1e-10, 1e-7
SI_FC = dict(Ecut=4.0, supercell_size=(2, 1, 1), scf_kwargs=dict(tol=1e-9), delta=3e-2)
PHI_REL_BAR, EWALD_FOLD_BAR = 1e-6, 1e-10
SPLIT_REL_BAR = 1e-9                # tests/test_chi0_split.py:52, test_phonon_split.py:36
SPLIT_METAL_BAR = 1e-8              # tests/test_phonon_split.py:67, absolute
KERNEL_EXACT_BAR = 1e-14            # A and B against their plain versions, of max|out|


def localized_potential(basis, width=2.0, amplitude=0.05):
    """A Gaussian bump [1, n1, n2, n3] of `width` bohr at the cell's centre
    (minimum image), float64 on the basis' device."""
    axes = [np.arange(n) / n for n in basis.fft_size]
    d = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1) - 0.5
    cart = (d - np.round(d)) @ np.asarray(basis.model.lattice).T
    return basis.tensor(amplitude * np.exp(-np.sum(cart ** 2, -1) / (2 * width ** 2))[None])


def mass_weighted_from_modes(freqs, vecs):
    """The mass-weighted dynamical matrix V diag(sign(f) f^2) V^H that
    phonon_modes_dfpt_q diagonalised (times the outer product of the
    masses' square roots: the force-constant matrix)."""
    return (vecs * (np.sign(freqs) * freqs ** 2)) @ vecs.conj().T


def supercell_basis(dt, model, Ecut, supercell_size, kgrid, device):
    """The undisplaced supercell of compute_force_constants (for holding
    the kernels at its shapes)."""
    from dftk_tpu_torch.supercell import create_supercell
    sc = create_supercell(model.lattice, model.atoms, model.positions, supercell_size)
    m = dt.model_DFT(sc["lattice"], sc["atoms"], sc["positions"],
                     functionals=["lda_x", "lda_c_vwn"], temperature=model.temperature)
    return dt.PlaneWaveBasis(m, Ecut=Ecut, kgrid=kgrid, device=device)


def split_result_of(res):
    """A complex SCF result (already on the full k-grid) as the split SCF's
    result dict: rows [x; y] per band, as tests/test_phonon_split.py makes it."""
    def host(a):
        return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    psi = host(res.psi)
    return dict(U=np.concatenate([psi.real, psi.imag], -1), occupation=host(res.occupation),
                eigenvalues=host(res.eigenvalues), rho=host(res.rho), epsF=float(res.epsF))


def q_phonon_phase(dt, la, device, smi, si54):
    """Phase o: phonons at q and the split response adapters on the card.
    o1: silicon at full width (symmetric, unfolded by the entry points):
    phonon_modes_dfpt_q at X and (0.25, 0, 0), dynmat_dfpt_q at (-0.25, 0, 0)
    (time reversal) and at 0 (against dynmat_dfpt_gamma), the IFC route's
    compute_force_constants and phonon_modes_q at X, phonon_band_structure;
    o2: magnesium's DFPT at X against its IFC route; o3: D(X) of the
    reference-size silicon, the si_fc force constants and the Ewald fold
    against the JAX package's values; o4: from phase c's Si54 split SCF
    (si54 = (basis, result)), apply_chi0_split_ctx and solve_dyson_split
    against the complex apply_chi0 and solve_dyson, and
    dynmat_dfpt_gamma_split against dynmat_dfpt_gamma (silicon, against
    the JAX package's too, and aluminium).  Returns the kernel launches of
    its runs and each kernel's max_abs_err at each run's shapes."""
    import torch
    from dftk_tpu_torch.interop import SCFState
    from dftk_tpu_torch.ops.engine_split import prepare_split_data
    from dftk_tpu_torch.ops.ewald import energy_ewald
    from dftk_tpu_torch.postprocess.phonon import (AMU_TO_ME, ATOMIC_MASSES_U, HARTREE_TO_CM1,
                                                   compute_force_constants,
                                                   phonon_band_structure, phonon_modes_q)
    from dftk_tpu_torch.response import chi0_split as cs
    from dftk_tpu_torch.response.phonon_dfpt import dynmat_dfpt_gamma
    from dftk_tpu_torch.response.phonon_q import (dynmat_dfpt_q, dynmat_ewald_q,
                                                  phonon_modes_dfpt_q)
    from dftk_tpu_torch.response.phonon_split import dynmat_dfpt_gamma_split
    from dftk_tpu_torch.scf.energy_eval import split_state_to_complex
    t_phase = time.time()
    with open(os.path.join(HERE, "tests", "data", "torch_port_phonon_q.json")) as f:
        ref = json.load(f)
    total, errs = {}, {}

    def run(label, tag, fn):
        return counted_run(la, smi, total, label, tag, fn)

    def against(tag, label, C, want, bar, scale=None):
        held_against(smi, tag, label, C, want, bar, scale)

    def b64(d):
        import base64
        return np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])).reshape(
            d["shape"])

    def freqs_against(tag, label, f, f_ifc, bar):
        diff = float(np.abs(f - f_ifc).max())
        print(f"[{tag}] {label} (cm^-1): DFPT {np.round(f * HARTREE_TO_CM1, 4).tolist()}, "
              f"IFC {np.round(f_ifc * HARTREE_TO_CM1, 4).tolist()}; max diff {diff:.3e} Ha "
              f"(bar {bar:.0e}; {smi})", flush=True)
        check(np.isfinite(f).all() and diff < bar, f"{label} within {bar} Ha")

    # o1: silicon at full width
    basis = si2_phonon_basis(dt, device, **SI_FULL_WIDTH)
    print(f"[o1] {basis}", flush=True)
    hold_kernels_at(la, basis, "o1 SCF", 4, errs, tag="o1", bar=KERNEL_EXACT_BAR)
    res = run("o1 Si2 SCF", "o1", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=60))
    hold_kernels_at(la, dt.unfold_bz(res).basis, "o1 DFPT at q", 4, errs, tag="o1",
                    bar=KERNEL_EXACT_BAR)
    f_X, _ = run("o1 phonon_modes_dfpt_q at X", "o1",
                 lambda: phonon_modes_dfpt_q(res, Q_X, **DFPT_TOLS))
    f_q, v_q = run("o1 phonon_modes_dfpt_q at (0.25, 0, 0)", "o1",
                   lambda: phonon_modes_dfpt_q(res, Q_QUARTER, **DFPT_TOLS))
    print(f"[o1] frequencies at (0.25, 0, 0) (cm^-1): "
          f"{np.round(f_q * HARTREE_TO_CM1, 4).tolist()}", flush=True)
    C_mq = run("o1 dynmat_dfpt_q at (-0.25, 0, 0)", "o1",
               lambda: dynmat_dfpt_q(res, [-x for x in Q_QUARTER], **DFPT_TOLS))
    msqrt = np.repeat(np.sqrt([ATOMIC_MASSES_U[at.symbol] * AMU_TO_ME
                               for at in basis.model.atoms]), 3)
    C_q = mass_weighted_from_modes(f_q, v_q) * np.outer(msqrt, msqrt)
    against("o1", "D(-q) against conj D(q) (time reversal)", C_mq, C_q.conj(), TIME_REVERSAL_BAR)
    C0q = run("o1 dynmat_dfpt_q at q = 0", "o1", lambda: dynmat_dfpt_q(res, [0, 0, 0], **DFPT_TOLS))
    C0 = run("o1 dynmat_dfpt_gamma without the sum rule", "o1", lambda: dynmat_dfpt_gamma(
        res, acoustic_sum_rule=False, **DFPT_TOLS))
    against("o1", "the q-code at q = 0 against the Gamma code (real part)", C0q.real, C0,
            GAMMA_Q_BAR)
    against("o1", "the q-code at q = 0 (imaginary part)", C0q.imag, np.zeros_like(C0),
            GAMMA_Q_IMAG_BAR)
    del res
    hold_kernels_at(la, supercell_basis(dt, basis.model, SI_FULL_WIDTH["Ecut"],
                                        IFC_SI["supercell_size"], IFC_SI["kgrid"], device),
                    "o1 IFC supercell", 8, errs, tag="o1", bar=KERNEL_EXACT_BAR)
    fc = run("o1 compute_force_constants (12 SCFs)", "o1", lambda: compute_force_constants(
        basis.model, Ecut=SI_FULL_WIDTH["Ecut"], basis_kwargs=dict(device=device), **IFC_SI))
    freqs_against("o1", "silicon at X, DFPT against IFC", f_X, phonon_modes_q(fc, Q_X)[0],
                  IFC_SI_BAR)
    bs = phonon_band_structure(fc)
    fb = bs["frequencies"]
    acoustic = float(np.abs(fb[0, :3]).max()) * HARTREE_TO_CM1
    print(f"[o1] phonon_band_structure: {fb.shape[0]} q-points "
          f"({' '.join(bs['qpath'].labels.values())}), highest "
          f"{fb.max() * HARTREE_TO_CM1:.4f} cm^-1, acoustic at Gamma {acoustic:.2e} cm^-1",
          flush=True)
    check(np.isfinite(fb).all() and np.allclose(bs["qpath"].kcoords[0], 0)
          and acoustic < ACOUSTIC_CM1, f"o1 band structure finite, acoustic < {ACOUSTIC_CM1}")
    del basis, fc
    torch.cuda.empty_cache()

    # o2: magnesium, DFPT at X against its IFC route
    basis = mg_phonon_basis(dt, device)
    mg_kw = dict(n_bands=6, n_extra_bands=4)
    hold_kernels_at(la, basis, "o2 Mg", 6, errs, tag="o2", block=10, bar=KERNEL_EXACT_BAR)
    res = run("o2 Mg SCF", "o2", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=80,
                                                                  **mg_kw))
    f_mg, _ = run("o2 Mg phonon_modes_dfpt_q at X", "o2",
                  lambda: phonon_modes_dfpt_q(res, Q_X, **DFPT_TOLS))
    fc = run("o2 Mg compute_force_constants (12 SCFs)", "o2", lambda: compute_force_constants(
        basis.model, Ecut=5.0, basis_kwargs=dict(device=device), **IFC_MG))
    freqs_against("o2", "magnesium at X, DFPT against IFC", f_mg, phonon_modes_q(fc, Q_X)[0],
                  IFC_MG_BAR)
    del res, basis, fc
    torch.cuda.empty_cache()

    # o3: against the JAX package's values
    r = ref["si2_q_converged"]
    basis = si2_phonon_basis(dt, device, Ecut=4.0, kgrid=(2, 2, 2))
    check(list(basis.fft_size) == r["fft_size"], "o3 Si2: the JAX package's FFT size")
    hold_kernels_at(la, basis, "o3 Si2", 4, errs, tag="o3", bar=KERNEL_EXACT_BAR)
    res = run("o3 Si2 SCF", "o3", lambda: dt.self_consistent_field(basis, tol=1e-12, maxiter=60))
    C = run("o3 Si2 dynmat_dfpt_q at X", "o3", lambda: dynmat_dfpt_q(res, Q_X, **DFPT_TOLS))
    against("o3", "Si2 D(X) against the JAX package's", C, b64(r["dynmat_X"]), JAX_REL_BAR,
            scale=True)
    fc = run("o3 si_fc compute_force_constants (12 SCFs)", "o3", lambda: compute_force_constants(
        basis.model, basis_kwargs=dict(device=device), **SI_FC))
    against("o3", "si_fc Phi against the JAX package's", fc.Phi, b64(ref["si_fc"]["Phi"]),
            PHI_REL_BAR, scale=True)
    # the Ewald dynamical matrix at X against the fold of the (2, 1, 1)
    # supercell's Ewald Hessian (double backward on the card)
    a = 5.13
    L = np.array([[0, a, a], [a, 0, a], [a, a, 0]], dtype=float)
    pos = np.array([[0.125, 0.125, 0.125], [-0.125, -0.125, -0.125]])
    Ls = L @ np.diag([2.0, 1.0, 1.0])
    pos_s = np.array([np.linalg.solve(np.diag([2.0, 1.0, 1.0]), p + np.array([c, 0, 0]))
                      for c in range(2) for p in pos])
    with torch.enable_grad():
        H = torch.autograd.functional.hessian(
            lambda p: energy_ewald(Ls, np.full(4, 4.0), p, device=device),
            torch.as_tensor(pos_s, dtype=torch.float64, device=device)).cpu().numpy()
    Linv = np.linalg.inv(Ls)
    Hc = np.einsum("aA,satb,bB->sAtB", Linv, H, Linv)
    ph = np.exp(2j * np.pi * (pos @ np.asarray(Q_X)))
    D_gauge = np.einsum("a,aibj,b->aibj", ph, dynmat_ewald_q(L, [4.0, 4.0], pos, Q_X), ph.conj())
    fold = Hc[:2, :, :2, :] - Hc[:2, :, 2:, :]
    against("o3", "dynmat_ewald_q at X against the supercell fold", D_gauge, fold, EWALD_FOLD_BAR)
    against("o3", "the supercell fold against the JAX package's", fold,
            b64(ref["ewald_q"]["fold_X"]), EWALD_FOLD_BAR)
    del res, basis, fc
    torch.cuda.empty_cache()

    # o4: the split adapters from phase c's Si54 split SCF, on its occupied
    # bands (its unoccupied ones left out, so that the complex path's Schur
    # complement has nothing to act on and both paths solve one system)
    basis, sres = si54
    occ_np = np.asarray(torch.as_tensor(sres["occupation"]).cpu())
    n_occ = int((occ_np > 1e-8).sum(1).max())
    occ_res = dict(U=sres["U"][:, :n_occ], occupation=sres["occupation"][:, :n_occ],
                   eigenvalues=sres["eigenvalues"][:, :n_occ], rho=sres["rho"], epsF=sres["epsF"])
    hold_kernels_at(la, basis, "o4 Si54 chi0", n_occ, errs, tag="o4", block=n_occ,
                    bar=KERNEL_EXACT_BAR)
    ctx = cs.make_chi0_split_context(basis, prepare_split_data(basis), occ_res)
    psi, occ = split_state_to_complex(basis, occ_res["U"], occ_res["occupation"])
    state = SCFState(basis=basis, psi=psi, occupation=occ, eigenvalues=ctx.eigenvalues,
                     epsF=float(sres["epsF"]),
                     rho=torch.as_tensor(sres["rho"], dtype=torch.float64, device=device))
    dV = localized_potential(basis)
    print(f"[o4] Si54 split state: {n_occ} occupied bands of {sres['U'].shape[1]}, "
          f"localized dV max {float(dV.max()):.3e}", flush=True)
    drho_s = run("o4 Si54 apply_chi0_split_ctx", "o4",
                 lambda: cs.apply_chi0_split_ctx(basis, ctx, dV, tol=1e-11))
    drho_c = run("o4 Si54 apply_chi0", "o4", lambda: dt.apply_chi0(
        dt.make_chi0_context(state, basis), basis, dV, tol=1e-11))
    against("o4", "Si54 split chi0 against the complex chi0", drho_s.cpu().numpy(),
            drho_c.cpu().numpy(), SPLIT_REL_BAR, scale=True)
    drho_ds, _ = run("o4 Si54 solve_dyson_split", "o4", lambda: cs.solve_dyson_split(
        basis, ctx, dV, sres["rho"], tol=1e-9, sternheimer_tol=1e-11))
    drho_dc, _ = run("o4 Si54 solve_dyson", "o4", lambda: dt.solve_dyson(
        state, dV, basis=basis, tol=1e-9, sternheimer_tol=1e-11))
    against("o4", "Si54 split Dyson against the complex Dyson", drho_ds.cpu().numpy(),
            drho_dc.cpu().numpy(), SPLIT_REL_BAR, scale=True)
    del ctx, state, psi, drho_s, drho_c, drho_ds, drho_dc
    torch.cuda.empty_cache()

    # o4: the split Gamma DFPT at tests/test_phonon_split.py's sizes
    Al = dt.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    al_model = dt.model_DFT(AL_FCC, [Al], [np.array([0.03, 0.0, 0.0])],
                            functionals=["lda_x", "lda_c_vwn"], temperature=1e-2,
                            symmetries=False)
    cells = (("silicon", si2_phonon_basis(dt, device, Ecut=5.0, kgrid=(2, 2, 2)), {},
              SPLIT_REL_BAR, True),
             ("aluminium", dt.PlaneWaveBasis(al_model, Ecut=5.0, kgrid=(2, 2, 2), device=device),
              dict(maxiter=80, n_bands=6, n_extra_bands=4), SPLIT_METAL_BAR, False))
    for name, basis, kw, bar, rel in cells:
        hold_kernels_at(la, basis, f"o4 {name} split DFPT", 4, errs, tag="o4",
                        block=10 if kw else None, bar=KERNEL_EXACT_BAR)
        res = run(f"o4 {name} SCF", "o4", lambda: dt.self_consistent_field(
            basis, tol=1e-12, **{"maxiter": 60, **kw}))
        u = dt.unfold_bz(res)
        C_s = run(f"o4 {name} dynmat_dfpt_gamma_split", "o4", lambda: dynmat_dfpt_gamma_split(
            u.basis, prepare_split_data(u.basis), split_result_of(u), tol=1e-8,
            sternheimer_tol=1e-11))
        C_c = run(f"o4 {name} dynmat_dfpt_gamma", "o4", lambda: dynmat_dfpt_gamma(
            res, tol=1e-8, sternheimer_tol=1e-11))
        against("o4", f"{name} split dynmat against dynmat_dfpt_gamma", C_s, C_c, bar,
                scale=rel or None)
        if name == "silicon":
            against("o4", "silicon split dynmat against the JAX package's split value", C_s,
                    b64(ref["phonon_split"]["dynmat"]), JAX_REL_BAR, scale=True)
        del res, u
    torch.cuda.empty_cache()
    print(f"[o] phase o took {time.time() - t_phase:.1f} s; launches {total}", flush=True)
    return total, errs


# phase p: exact exchange and DFT+U; the cells of tests/data/make_torch_port_exx.py
# (copied: this script imports nothing of tests/), the JAX package's CPU float64
# values in tests/data/torch_port_exx.json
EXX_LOOPS_BAR = 1e-7          # Si54 HSE06: LOBPCG against the split CheFSI SCF (Ha)
EXX_ACE_BAR = 1e-9            # the ACE exchange energy against the bare one (Ha)
EXX_ACE_JITTER = 1e-12        # ops/exx_ace.py::build_ace's default jitter
EXX_JAX_REL_BAR = 1e-10       # the Si54 exchange against the JAX package's (relative)
EXX_SCF_BAR = 1e-7            # the SCFs against the JAX package's and k-grid against supercell
EXX_SCF_TOL = 1e-9            # the density tolerance of p3-p5's SCFs
EXX_SI54_TOL = 1e-10          # the energy tolerance of p1's Si54 HSE06 SCFs (Ha)
EXX_MAXITER = 150
SI54_N_BANDS, SI54_N_OCC, SI54_SEED = 118, 108, 54
KGRID_L, KGRID_RC, KGRID_ECUT = 8.0, 4.0, 5.0
HUBBARD_U = 0.15


def seeded_orbitals(mask, n_bands, seed):
    """Orthonormal complex orbitals [nk, n_bands, nG] (numpy), zero on the
    padding of mask [nk, nG] (tests/data/make_torch_port_exx.py)."""
    rng = np.random.default_rng(seed)
    shape = (mask.shape[0], n_bands, mask.shape[1])
    psi = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, None, :]
    out = np.empty_like(psi)
    for k in range(psi.shape[0]):
        out[k] = np.linalg.qr(psi[k].T)[0].T
    return out


def si54_hse_basis(dt, device):
    """bench.py's Si54 geometry (n_rep 3) under HSE06, pbe/si-q4, Ecut 10,
    Gamma, no symmetry (64^3 grid)."""
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]]) * 3
    Si = dt.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    positions = [(b + np.array([i, j, k])) / 3 for i in range(3) for j in range(3)
                 for k in range(3) for b in SI_POSITIONS]
    model = dt.HSE06(lattice, [Si] * len(positions), positions, symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)


def hf_terms(dt, kernel):
    return [dt.Kinetic(), dt.AtomicLocal(), dt.AtomicNonlocal(), dt.Ewald(),
            dt.PspCorrection(), dt.Hartree(), dt.ExactExchange(scaling_factor=1.0, kernel=kernel)]


def he_kgrid_bases(dt, device):
    """HF helium with the truncated kernel of radius 4: (the cell on the
    (2, 1, 1) grid, the doubled cell at Gamma)."""
    He = dt.ElementPsp.from_symbol("He", psp="lda/he-q2")
    kern = dt.SphericallyTruncatedCoulomb(rc=KGRID_RC)
    prim = dt.Model(np.diag([KGRID_L] * 3), [He], [np.array([.5, .5, .5])],
                    term_types=hf_terms(dt, kern), symmetries=False)
    sc = dt.Model(np.diag([2 * KGRID_L, KGRID_L, KGRID_L]), [He, He],
                  [np.array([.25, .5, .5]), np.array([.75, .5, .5])],
                  term_types=hf_terms(dt, kern), symmetries=False)
    return (dt.PlaneWaveBasis(prim, Ecut=KGRID_ECUT, kgrid=(2, 1, 1), fft_size=(16, 16, 16),
                              device=device),
            dt.PlaneWaveBasis(sc, Ecut=KGRID_ECUT, kgrid=(1, 1, 1), fft_size=(32, 16, 16),
                              device=device))


def hybrid_bases(dt, device):
    """name -> basis of examples/hse_r2scan_silicon.py's HSE06 silicon and
    examples/hybrid_he.py's HF and PBE0 helium."""
    Si = dt.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    He = dt.ElementPsp.from_symbol("He", psp="lda/he-q2")
    si = dt.HSE06(10.26 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]]), [Si, Si],
                  SI_POSITIONS)
    he = {name: fn(np.eye(3) * 10.0, [He], [np.array([.5, .5, .5])], symmetries=False)
          for name, fn in (("he_hf", dt.model_HF), ("he_pbe0", dt.PBE0))}
    out = {"si2_hse06": dt.PlaneWaveBasis(si, Ecut=10.0, kgrid=(1, 1, 1), device=device)}
    out.update({k: dt.PlaneWaveBasis(m, Ecut=15.0, kgrid=(1, 1, 1), device=device)
                for k, m in he.items()})
    return out


def c2_hubbard_basis(dt, device):
    """examples/hubbard.py's C2 PBE+U: C_m.upf in the silicon cell, U 0.15
    on the p manifolds of both atoms, Ecut 10, kgrid 2^3, symmetric."""
    C = dt.ElementPsp.from_symbol("C", psp=os.path.join(HERE, C_UPF))
    mfs = (dt.HubbardManifold(atom_index=0, l=1, U=HUBBARD_U),
           dt.HubbardManifold(atom_index=1, l=1, U=HUBBARD_U))
    model = dt.model_DFT(SI_LATTICE, [C, C], SI_POSITIONS, functionals="PBE",
                         extra_terms=[dt.Hubbard(manifolds=mfs)])
    return dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(2, 2, 2), device=device)


def exchange_ms(hamops, exx, psi, reps=3):
    """ms per bare exchange apply of exx to psi (CUDA-synchronised, the
    median of reps after one warm-up)."""
    import torch
    hamops.apply_exchange(exx, psi)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hamops.apply_exchange(exx, psi)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def exx_scf(dt, la, smi, run, label, basis, loop, n_bands, tol=EXX_SCF_TOL,
            is_converged="density", **kw):
    """One SCF of phase p on the card: kernels A and B held at its band block
    first, then `loop` ("lobpcg": self_consistent_field; "split":
    self_consistent_field_split with CheFSI) under run_on_card, its
    launches added to run["launches"].  Returns (result, energies)."""
    from dftk_tpu_torch.ops import exx_ace
    hold_kernels_at(la, basis, label, n_bands, run["errs"], tag="p")
    exx_ace.counts.reset()

    def show(info):
        print(f"[p] {label} it={info['n_iter']:3d} E={info['E']:.12f} "
              f"drho={info['drho']:.3e}", flush=True)
    if loop == "lobpcg":
        fn = lambda: dt.self_consistent_field(basis, tol=tol, maxiter=EXX_MAXITER,
                                              n_bands=n_bands, is_converged=is_converged,
                                              callback=show, **kw)
    else:
        fn = lambda: dt.self_consistent_field_split(
            basis, tol=tol, maxiter=EXX_MAXITER, n_bands=n_bands, eigensolver="chefsi",
            is_converged=is_converged, callback=show, **kw)
    res, launches = run_on_card(la, label, smi, fn, tag="p")
    for k, v in launches.items():
        run["launches"][k] = run["launches"].get(k, 0) + v
    E, n_iter, conv = ((res.energies, res.n_iter, res.converged) if loop == "lobpcg"
                       else (res["energies"], res["n_iter"], res["converged"]))
    print(f"[p] {label}: converged={conv} n_iter={n_iter} ACE builds "
          f"{exx_ace.counts.builds} E={E['total']:.12f} "
          + " ".join(f"{k}={E[k]:.12f}" for k in ("ExactExchange", "Hubbard") if k in E),
          flush=True)
    check(conv and np.isfinite(E["total"]), f"{label} converged")
    return res, E


def exx_si54(dt, la, device, smi, run, ref):
    """p1 and p2: Si54 HSE06 through both loops, ACE against the bare
    exchange at the converged state, and the exchange of seeded orbitals
    against the JAX package's."""
    import torch
    from dftk_tpu_torch.ops import exx_ace
    from dftk_tpu_torch.ops import hamiltonian as hamops
    from dftk_tpu_torch.ops.coulomb import Coulomb, exx_q_kernels
    basis = si54_hse_basis(dt, device)
    print(f"[p] p1 {basis}", flush=True)
    conv = dict(tol=EXX_SI54_TOL, is_converged="energy")
    res_l, E_l = exx_scf(dt, la, smi, run, "p1 Si54 HSE06 LOBPCG", basis, "lobpcg", SI54_N_OCC,
                         **conv)
    _, E_s = exx_scf(dt, la, smi, run, "p1 Si54 HSE06 split CheFSI", basis, "split",
                     SI54_N_OCC, **conv)
    dE = abs(E_l["total"] - E_s["total"])
    print(f"[p] p1 Si54 HSE06: LOBPCG {E_l['total']:.12f}, split {E_s['total']:.12f}, "
          f"|dE| {dE:.3e} (bar {EXX_LOOPS_BAR:.0e}; {smi})", flush=True)
    check(dE < EXX_LOOPS_BAR, "p1 Si54 HSE06 loops agree")
    psi, occ = res_l.psi, torch.as_tensor(res_l.occupation, device=device)
    bd, td, model = basis.data, basis.terms.data, basis.model
    exx = hamops.make_exchange(bd, td, psi, occ, model.filled_occupation,
                               model.unit_cell_volume)
    vx = hamops.apply_exchange(exx, psi)
    diag = torch.sum(psi.conj() * vx, -1).real                     # [nk, nb]
    wf = bd.kweights[:, None] * occ
    E_bare = float(0.5 * torch.sum(wf * diag))
    xi = exx_ace.build_ace(exx)
    band = torch.sum(psi.conj() * exx_ace.apply_ace(xi, psi), -1).real
    E_ace = float(0.5 * torch.sum(wf * band))
    # ACE regularises -Psi^H Vx Psi with eps = jitter max(tr, 1) (exx_ace.py):
    # on the span Psi^H V_ACE Psi = M + eps - O(eps^2), so E_ACE = E_x + eps sum(w f) / 2
    eps = EXX_ACE_JITTER * max(-float(diag.sum()), 1.0)
    shift = 0.5 * eps * float(wf.sum())
    d = abs(E_ace - E_bare - shift)
    ms = exchange_ms(hamops, exx, psi)
    print(f"[p] p1 Si54 HSE06 exchange at the converged state: bare {E_bare:.12f}, "
          f"ACE {E_ace:.12f}, ACE - bare {E_ace - E_bare:.3e}, the jitter's shift "
          f"eps sum(w f) / 2 {shift:.3e}, |ACE - bare - shift| {d:.3e} (bar "
          f"{EXX_ACE_BAR:.0e}); one bare apply to {psi.shape[1]} bands "
          f"({int((occ > 0).sum())} generators, grid {basis.fft_size}) {ms:.1f} ms ({smi})",
          flush=True)
    check(d < EXX_ACE_BAR, "p1 ACE exact on the span (but for its jitter's shift)")
    del res_l, psi, exx, xi, vx
    torch.cuda.empty_cache()

    r54 = ref["si54_exx"]
    check(list(basis.fft_size) == r54["fft_size"] and basis.nG_max == r54["nG"],
          "p2 the JAX package's Si54 basis")
    psi = torch.as_tensor(seeded_orbitals(basis.mask_np, SI54_N_BANDS, SI54_SEED),
                          device=device)
    occ = torch.zeros((1, SI54_N_BANDS), dtype=torch.float64, device=device)
    occ[:, :SI54_N_OCC] = 2.0
    for name, kern in (("hse", td.exx_kernel),
                       ("coulomb", basis.tensor(exx_q_kernels(Coulomb(), basis)[0]))):
        exx = hamops.make_exchange(bd, td._replace(exx_kernel=kern), psi, occ, 2.0,
                                   model.unit_cell_volume)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vx = hamops.apply_exchange(exx, psi)
        diag = torch.sum(psi.conj() * vx, -1).real[0].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        E = 0.5 * float(np.sum(occ[0].cpu().numpy() * diag))
        want = np.asarray(r54[name]["diag"])
        d_rel = float(np.max(np.abs(diag - want)) / np.max(np.abs(want)))
        e_rel = abs(E - r54[name]["E"]) / abs(r54[name]["E"])
        print(f"[p] p2 Si54 {name} exchange of seeded orbitals: E_x {E:.12f} (JAX "
              f"{r54[name]['E']:.12f}), relative {e_rel:.3e}, diagonal {d_rel:.3e} "
              f"(bar {EXX_JAX_REL_BAR:.0e}); one apply {ms:.1f} ms (JAX CPU "
              f"{r54[name]['apply_seconds']:.1f} s; {smi})", flush=True)
        check(e_rel < EXX_JAX_REL_BAR and d_rel < EXX_JAX_REL_BAR, f"p2 Si54 {name} exchange")
        del vx, exx
    del basis, psi
    torch.cuda.empty_cache()


def exx_small(dt, la, device, smi, run, ref):
    """p3-p5: the hybrids, the k-grid exchange and DFT+U against the JAX
    package's energies."""
    import torch
    for name, basis in hybrid_bases(dt, device).items():
        want = ref["hybrids"][name]
        check(list(basis.fft_size) == want["fft_size"], f"p3 {name} grid")
        psi0 = torch.as_tensor(seeded_orbitals(basis.mask_np, want["n_bands"], 6),
                               device=device)
        n_occ = basis.model.default_n_bands()
        _, E = exx_scf(dt, la, smi, run, f"p3 {name}", basis, "lobpcg", n_occ, psi=psi0,
                       n_extra_bands=want["n_bands"] - n_occ)
        held_against(smi, "p", f"p3 {name} against JAX", E["total"],
                     want["energies"]["total"], EXX_SCF_BAR)

    bp, bs = he_kgrid_bases(dt, device)
    rk = ref["he_kgrid"]
    for loop in ("lobpcg", "split"):
        Es = {}
        for tag, b in (("kgrid", bp), ("supercell", bs)):
            nb = rk[tag]["n_bands"]
            n_occ = b.model.default_n_bands()
            psi0 = seeded_orbitals(b.mask_np, nb, 5)
            kw = (dict(psi=torch.as_tensor(psi0, device=device)) if loop == "lobpcg" else
                  dict(U0=np.concatenate([psi0.real, psi0.imag], axis=-1)))
            _, E = exx_scf(dt, la, smi, run, f"p4 He {tag} {loop}", b, loop, n_occ,
                           n_extra_bands=nb - n_occ, **kw)
            Es[tag] = E["total"]
            held_against(smi, "p", f"p4 He {tag} {loop} against JAX", E["total"],
                         rk[tag]["energies"]["total"], EXX_SCF_BAR)
        held_against(smi, "p", f"p4 He {loop} k-grid against supercell per cell",
                     Es["kgrid"], Es["supercell"] / 2, EXX_SCF_BAR)

    basis = c2_hubbard_basis(dt, device)
    rc = ref["c2_hubbard"]
    check(list(basis.fft_size) == rc["fft_size"] and basis.n_kpoints == rc["n_kpoints"]
          and len(basis.symmetries) == rc["n_symmetries"], "p5 the JAX package's C2 basis")
    n_occ = basis.model.default_n_bands()
    psi0 = seeded_orbitals(basis.mask_np, n_occ + 3, 8)
    Eu = {}
    for loop in ("lobpcg", "split"):
        kw = (dict(psi=torch.as_tensor(psi0, device=device)) if loop == "lobpcg" else
              dict(U0=np.concatenate([psi0.real, psi0.imag], axis=-1)))
        _, E = exx_scf(dt, la, smi, run, f"p5 C2 PBE+U {loop}", basis, loop, n_occ,
                       n_extra_bands=3, **kw)
        Eu[loop] = E
        for key in ("total", "Hubbard"):
            held_against(smi, "p", f"p5 C2 PBE+U {loop} {key} against JAX", E[key],
                         rc["scf"]["energies"][key], EXX_SCF_BAR)
    held_against(smi, "p", "p5 C2 PBE+U split against LOBPCG", Eu["split"]["total"],
                 Eu["lobpcg"]["total"], EXX_SCF_BAR)


def exx_phase(dt, la, device, smi):
    """Phase p: exact exchange and DFT+U on the card.  p1: Si54 HSE06 at
    full width through both SCF loops with ACE, their energies within
    EXX_LOOPS_BAR, the converged state's ACE exchange energy within
    EXX_ACE_BAR of the bare one; p2: the Si54 exchange of seeded orbitals
    (HSE06 and bare Coulomb) against the JAX package's; p3: HSE06 silicon
    and HF and PBE0 helium against the JAX package's energies; p4: HF
    helium on the (2, 1, 1) grid against its doubled cell at Gamma, in both
    loops and against JAX; p5: C2 PBE+U in both loops against JAX (total
    and Hubbard) and each other.  Kernels A and B are held against their
    plain versions at each run's band block before it.  Returns the kernel
    launches of its runs and each kernel's max_abs_err at each run's shapes."""
    with open(os.path.join(HERE, "tests", "data", "torch_port_exx.json")) as f:
        ref = json.load(f)
    run = dict(launches={}, errs={})
    t0 = time.time()
    exx_si54(dt, la, device, smi, run, ref)
    exx_small(dt, la, device, smi, run, ref)
    print(f"[p] phase p: {time.time() - t0:.1f} s; launches {run['launches']} ({smi})",
          flush=True)
    return run["launches"], run["errs"]

# ---------------------------------------------------------------------------
# q. the model Hamiltonians' terms: the cells of
#    tests/data/make_torch_port_terms.py (loaded, with the port as their
#    package), whose JAX values phase q reads
# ---------------------------------------------------------------------------

Q_LOOPS_BAR = 1e-7            # q1: the LOBPCG against the split SCF (Ha)
Q_FD_STEP = 1e-3              # q1: the central difference's step (bohr)
Q_FD_BAR = 1e-5               # q1: forces against the central difference (Ha/bohr)
Q_JAX_REL_BAR = 1e-10         # q1: the apply and the pairwise term against JAX (relative)
Q_JAX_E_BAR = 1e-7            # q2-q4: energies against the JAX package's (Ha)
FD_BARS = dict(spectrum=2e-4, total=5e-4, parts=1e-10, lz=1e-3)   # tests/test_magnetic.py
ANYON_E, ANYON_E_BAR = 4.64955, 5e-3             # tests/test_anyonic.py:189
GP2D_MAXITER = 600


def load_terms_cells():
    """tests/data/make_torch_port_terms.py as a module: its constructors take
    the package as an argument, and loading it imports nothing of JAX
    (checked here)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_terms", os.path.join(HERE, "tests", "data", "make_torch_port_terms.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dftk_tpu")],
          "phase q: loading the cells imported no JAX")
    return make


def summary_against(smi, label, make, table, want, bar):
    """A table's fingerprint (make_torch_port_exx.py::table_summary) against
    the JAX one's: each part within bar of the largest of its own size and
    the table's scale (the largest magnitude of the sampled values)."""
    got = make.table_summary(table)
    check(got["size"] == want["size"], f"{label}: size")
    scale = max(np.abs(want["sample"]).max(), abs(want["first"]))
    for key in ("first", "sum", "wsum", "sample"):
        held_against(smi, "q", f"{label} {key}", got[key], want[key],
                     bar * max(scale, float(np.abs(want[key]).max())))


def time_unit_axes(la, basis, label, n_bands, smi):
    """ms per launch (CUDA events, median of 10) of kernels A (forward and
    backward) and B, complex128 and bf16, and of their plain versions, on a
    band block of a 2D or 1D basis (compact axes of 8 over grid axes of
    1), with their bounds.  Not counted: called outside the runs."""
    import torch
    pf, n = basis.pruned, basis.fft_size
    rng = np.random.default_rng(7)
    shape = (basis.n_kpoints, n_bands) + pf.m_shape
    xc_np = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    V_np = rng.normal(size=(basis.n_kpoints, n[2], n[0], n[1]))
    for dtype, prec, esize in ((torch.complex128, "highest", 16), (torch.complex64, "default", 8)):
        fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in pf.factors.fwd),
                              bwd=tuple(f.to(dtype) for f in pf.factors.bwd))
        xc = torch.as_tensor(xc_np, device=basis.device).to(dtype)
        V = torch.as_tensor(V_np, device=basis.device).to(
            torch.float64 if prec == "highest" else torch.float32)
        t = la.pruned_axis_dft_plain(xc, fac.fwd[2], True, prec).contiguous()
        kind = "complex128" if prec == "highest" else "bf16"
        work = {"A forward": axis_dft_work(tuple(xc.shape), pf.m_shape[2], n[2], esize),
                "A backward": axis_dft_work(tuple(t.shape), n[2], pf.m_shape[2], esize),
                "B": local_plane_work(tuple(t.shape), n[0], n[1], esize)}
        for name, kern, plain in (
                ("A forward", lambda: la.pruned_axis_dft(xc, fac.fwd[2], True, prec),
                 lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True, prec)),
                ("A backward", lambda: la.pruned_axis_dft(t, fac.bwd[2], False, prec),
                 lambda: la.pruned_axis_dft_plain(t, fac.bwd[2], False, prec)),
                ("B", lambda: la.local_plane(t, V, fac, precision=prec),
                 lambda: la.local_plane_plain(t, V, fac, prec))):
            bound_ms, by = bound(*(work[name], kind))
            print(f"[q] {label} {name} {kind} at x {tuple(xc.shape)}, grid {n}: "
                  f"{cuda_ms(kern):.4f} ms, plain {cuda_ms(plain):.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({by}) ({smi})", flush=True)


def q_run(la, smi, run, label, fn, n_iter_of, bf16=False):
    """One run of phase q under run_on_card: its launches added to
    run["launches"], its iterations printed; bf16: the bf16 kernels must
    have launched too."""
    out, launches = run_on_card(la, label, smi, fn, tag="q")
    for k, v in launches.items():
        run["launches"][k] = run["launches"].get(k, 0) + v
    if bf16:
        check(launches["pruned_axis_dft[bf16]"] > 0 and launches["local_plane[bf16]"] > 0,
              f"{label}: every bf16 kernel launched")
    print(f"[q] {label}: {n_iter_of(out)} iterations", flush=True)
    return out


def terms_q1(dt, la, device, smi, run, ref, make):
    """q1: Si54 at full width with the kinetic blow-up, the external
    potential and the pairwise term."""
    import torch
    from dftk_tpu_torch.ops import hamiltonian as hamops
    t0 = time.time()
    basis = make.si54_q1_basis(dt, device=device)
    print(f"[q] q1 {basis} set up in {time.time() - t0:.1f} s; explicit kinetic up to "
          f"{float(basis.terms.data.kin.max()):.6e} Ha", flush=True)
    check(list(basis.fft_size) == ref["fft_size"] and basis.nG_max == ref["nG"],
          "q1: the JAX package's basis")
    summary_against(smi, "q1 explicit kinetic", make, basis.terms.kin_np, ref["kin"], Q_JAX_REL_BAR)
    held_against(smi, "q", "q1 pairwise E against JAX", basis.terms.E_pairwise,
                 ref["E_pairwise"], Q_JAX_REL_BAR, scale=True)
    # the perfect crystal's pairwise forces vanish: held in units of its energy
    held_against(smi, "q", "q1 pairwise F against JAX", basis.terms.pairwise_forces,
                 np.array(ref["F_pairwise"]), Q_JAX_REL_BAR * abs(ref["E_pairwise"]))
    vol = basis.model.unit_cell_volume
    V, _, _ = hamops.total_potential(basis.terms, dt.guess_density(basis), vol)
    ham = hamops.build_ham(basis.data, basis.terms.data, V, basis.pruned)
    psi = torch.as_tensor(make.seeded_orbitals(basis.mask_np, 8, 54), device=device)
    hold_kernels_at(la, basis, "q1 apply", 8, run["errs"], tag="q", block=8)
    Hpsi = run_on_card(la, "q1 one apply of H to 8 bands", smi,
                       lambda: hamops.apply_H(ham, psi), tag="q")[0]
    diag = torch.sum(psi.conj() * Hpsi, -1).real[0].cpu().numpy()
    held_against(smi, "q", "q1 apply: band diagonal against JAX", diag, np.array(ref["diag"]),
                 Q_JAX_REL_BAR, scale=True)
    summary_against(smi, "q1 apply: Re H psi", make, Hpsi.real.cpu().numpy(), ref["Hpsi_re"],
                    Q_JAX_REL_BAR)
    summary_against(smi, "q1 apply: Im H psi", make, Hpsi.imag.cpu().numpy(), ref["Hpsi_im"],
                    Q_JAX_REL_BAR)
    del ham, psi, Hpsi

    def show(info):
        print(f"[q] q1 it={info['n_iter']:3d} E={info['E']:.12f} drho={info['drho']:.3e}",
              flush=True)

    n_bands = basis.model.default_n_bands()
    hold_kernels_at(la, basis, "q1 Si54 blow-up", n_bands, run["errs"], bf16=True, tag="q")
    res = q_run(la, smi, run, "q1 Si54 blow-up LOBPCG",
                lambda: dt.self_consistent_field(basis, tol=1e-8, is_converged="density",
                                                 callback=show), lambda r: r.n_iter)
    check(res.converged, "q1 LOBPCG converged")
    split = q_run(la, smi, run, "q1 Si54 blow-up split (mixed)",
                  lambda: dt.self_consistent_field_split(
                      basis, tol=1e-8, is_converged="density", eigensolver="chefsi",
                      diagtol_min=1e-10, callback=show), lambda r: r["n_iter"], bf16=True)
    check(split["converged"], "q1 split converged")
    # the same loop without its bf16 LOBPCG cycles (exact LOBPCG on every
    # step): the walls of the two say what the bf16 cycles buy
    exact = q_run(la, smi, run, "q1 Si54 blow-up split (highest)",
                  lambda: dt.self_consistent_field_split(
                      basis, tol=1e-8, is_converged="density", eigensolver="chefsi",
                      filter_precision="highest", diagtol_min=1e-10, callback=show),
                  lambda r: r["n_iter"])
    check(exact["converged"], "q1 split (highest) converged")
    E = {"lobpcg": res.energies, "split": split["energies"], "split_highest": exact["energies"]}
    print(f"[q] q1 energies {E}", flush=True)
    for name in ("split", "split_highest"):
        held_against(smi, "q", f"q1 {name} against LOBPCG", E[name]["total"],
                     E["lobpcg"]["total"], Q_LOOPS_BAR)
    check(E["lobpcg"]["PairwisePotential"] == basis.terms.E_pairwise
          and E["split"]["PairwisePotential"] == basis.terms.E_pairwise,
          "q1: both loops carry the pairwise energy")
    t0 = time.time()
    F = dt.compute_forces_cart(res).cpu().numpy()
    print(f"[q] q1 forces in {time.time() - t0:.2f} s: F[0] = {F[0]}, sum {F.sum(0)}",
          flush=True)
    Es = []
    for sign in (1, -1):
        b = make.si54_q1_basis(dt, shift=sign * Q_FD_STEP, device=device)
        r = q_run(la, smi, run, f"q1 Si54 atom 0 moved by {sign * Q_FD_STEP:+.0e} bohr",
                  lambda: dt.self_consistent_field(b, tol=1e-10, is_converged="density",
                                                   psi=res.psi, rho=res.rho),
                  lambda r: r.n_iter)
        check(r.converged, "q1 displaced SCF converged")
        Es.append(r.total_energy)
        del b, r
    F_fd = -(Es[0] - Es[1]) / (2 * Q_FD_STEP)
    held_against(smi, "q", "q1 force on atom 0 along x against the central difference",
                 F[0, 0], F_fd, Q_FD_BAR)
    return E["lobpcg"]["total"]


def terms_q2(dt, la, device, smi, run, ref, make):
    """q2: Fock-Darwin at Ecut 24 against its exact spectrum, and the
    rotating 2D GP by direct minimization."""
    import torch
    from dftk_tpu_torch.postprocess.current import compute_current
    b = make.fock_darwin_basis(dt, device=device)
    hold_kernels_at(la, b, "q2 Fock-Darwin", 6, run["errs"], bf16=True, tag="q")
    time_unit_axes(la, b, "q2 Fock-Darwin (n3 = 1)", 9, smi)
    res = q_run(la, smi, run, "q2 Fock-Darwin LOBPCG",
                lambda: dt.self_consistent_field(b, tol=1e-10, n_bands=6, maxiter=30),
                lambda r: r.n_iter)
    B = make.FD_B
    Om = np.sqrt(make.FD_W0 ** 2 + B ** 2 / 4)
    exact = np.sort([Om, 2 * Om - B / 2, 2 * Om + B / 2, 3 * Om - B, 3 * Om, 3 * Om + B])
    held_against(smi, "q", "q2 Fock-Darwin spectrum against exact",
                 np.sort(res.eigenvalues[0, :6]), exact, FD_BARS["spectrum"])
    held_against(smi, "q", "q2 Fock-Darwin total against exact", res.total_energy,
                 3 * Om - B / 2, FD_BARS["total"])
    E = res.energies
    held_against(smi, "q", "q2 Fock-Darwin bookkeeping", E["Kinetic"] + E["AtomicLocal"]
                 + E["Magnetic"], res.total_energy, FD_BARS["parts"])
    Lz = make.lz(b, compute_current(res).cpu().numpy())
    held_against(smi, "q", "q2 Fock-Darwin L_z from compute_current", Lz, -1.0, FD_BARS["lz"])

    b = make.gp2d_basis(dt, device=device)
    want = ref["gp_direct"]["gp2d"]
    check(list(b.fft_size) == want["fft_size"], "q2 GP2D: the JAX package's grid")
    hold_kernels_at(la, b, "q2 rotating GP2D", 1, run["errs"], tag="q", block=1)
    psi0 = torch.as_tensor(make.seeded_orbitals(b.mask_np, 1, 1), device=device)
    d = q_run(la, smi, run, "q2 rotating GP2D direct minimization",
              lambda: dt.direct_minimization(b, tol=1e-6, maxiter=GP2D_MAXITER, psi=psi0),
              lambda r: r.n_iter)
    J = compute_current(d).cpu().numpy()
    j_norm = float(np.abs(J[0]).max() + np.abs(J[1]).max())
    print(f"[q] q2 GP2D: converged={d.converged} energies {d.energies}, in-plane current "
          f"{j_norm:.4f}", flush=True)
    check(d.converged == want["converged"], "q2 GP2D: converged as the JAX run")
    check(d.energies["Magnetic"] < -1e-3 and j_norm > 1e-4,
          "q2 GP2D: rotation lowers E and carries a current")
    held_against(smi, "q", "q2 GP2D against JAX", d.total_energy, want["energies"]["total"],
                 Q_JAX_E_BAR)


def terms_q3(dt, la, device, smi, run, make):
    """q3: anyons at Ecut 20 from the winding start, and the hand operator
    against torch.autograd at that size."""
    import torch
    from dftk_tpu_torch.ops.anyonic import anyonic_energy, apply_anyonic
    from dftk_tpu_torch.ops.density import compute_density
    b = make.anyon_basis(dt, Ecut=20.0, device=device)
    hold_kernels_at(la, b, "q3 anyons", 1, run["errs"], tag="q", block=1)
    psi0 = torch.as_tensor(make.winding_start(b), device=device)
    res = q_run(la, smi, run, "q3 anyons direct minimization",
                lambda: dt.direct_minimization(b, tol=1e-9, maxiter=4000, psi=psi0),
                lambda r: r.n_iter)
    E = res.total_energy
    s = 2
    e11 = (math.pi / 2 * (2 * (s + 1) / s) ** ((s + 2) / s) * (s / (s + 2)) ** (2 * (s + 1) / s)
           * E ** ((s + 2) / s) / make.ANYON_BETA) / (2 * math.pi)
    print(f"[q] q3 anyons: converged={res.converged} energies {res.energies}, "
          f"e(1,1)/(2 pi) = {e11:.4f}", flush=True)
    check(res.converged, "q3 anyons converged")
    held_against(smi, "q", "q3 anyons against tests/test_anyonic.py's energy", E, ANYON_E,
                 ANYON_E_BAR)
    check(1.1 <= e11 <= 1.3, "q3 e(1,1)/(2 pi) in the reference test's window")
    hbar, beta, rho_ref, Aref = b.terms.anyonic
    occ = torch.ones((1, 1), dtype=torch.float64, device=device)
    vol = b.model.unit_cell_volume

    def args(p, rho):
        return (occ, torch.sum(rho, dim=0), b.tensor(rho_ref), b.tensor(Aref),
                b.terms.data.G_cart, hbar, beta, b.fft_size, vol)

    psi = res.psi
    with torch.enable_grad():
        x = psi.clone().requires_grad_(True)
        r = compute_density(b.data, x, occ, b.fft_size, vol, 1)
        (g,) = torch.autograd.grad(anyonic_energy(b.data, x, *args(x, r)), x)
    rho = compute_density(b.data, psi, occ, b.fft_size, vol, 1)
    hand = 2 * apply_anyonic(b.data, psi, *args(psi, rho))
    held_against(smi, "q", "q3 hand operator against torch.autograd", hand.cpu().numpy(),
                 g.cpu().numpy(), 1e-12, scale=True)


def terms_q4(dt, la, device, smi, run, ref, make):
    """q4: the 1D GP with its forces, and the 3D GP by direct minimization,
    against the JAX package's energies from the same starts."""
    import torch
    b = make.gp1d_basis(dt, device=device)
    want = ref["gp1d"]
    check(list(b.fft_size) == want["fft_size"], "q4 GP1D: the JAX package's grid")
    hold_kernels_at(la, b, "q4 GP1D", 1, run["errs"], bf16=True, tag="q", block=4)
    time_unit_axes(la, b, "q4 GP1D (n2 = n3 = 1)", 4, smi)
    psi0 = torch.as_tensor(make.seeded_orbitals(b.mask_np, 4, 26), device=device)
    rho0 = torch.zeros((1,) + b.fft_size, dtype=torch.float64, device=device)
    res = q_run(la, smi, run, "q4 GP1D LOBPCG",
                lambda: dt.self_consistent_field(b, tol=1e-10, maxiter=60, psi=psi0, rho=rho0),
                lambda r: r.n_iter)
    check(res.converged, "q4 GP1D converged")
    held_against(smi, "q", "q4 GP1D against JAX", res.total_energy, want["energies"]["total"],
                 Q_JAX_E_BAR)
    F = dt.compute_forces(res).cpu().numpy()
    held_against(smi, "q", "q4 GP1D forces against JAX", F, np.array(want["forces"]), 1e-7)
    check(abs(F[0, 0] + F[1, 0]) < 1e-5, "q4 GP1D: |F0 + F1| < 1e-5")

    b = make.gp3d_basis(dt, device=device)
    want = ref["gp_direct"]["gp3d"]
    check(list(b.fft_size) == want["fft_size"], "q4 GP3D: the JAX package's grid")
    hold_kernels_at(la, b, "q4 GP3D", 1, run["errs"], tag="q", block=1)
    psi0 = torch.as_tensor(make.seeded_orbitals(b.mask_np, 1, 2), device=device)
    d = q_run(la, smi, run, "q4 GP3D direct minimization",
              lambda: dt.direct_minimization(b, tol=1e-9, maxiter=300, psi=psi0),
              lambda r: r.n_iter)
    check(d.converged, "q4 GP3D converged")
    held_against(smi, "q", "q4 GP3D against JAX", d.total_energy, want["energies"]["total"],
                 Q_JAX_E_BAR)


def terms_phase(dt, la, device, smi):
    """Phase q: the model Hamiltonians' terms on the card (the kinetic
    blow-up, External*, LocalNonlinearity, Magnetic with the current,
    Anyonic, PairwisePotential), on 3D, 2D (n3 = 1) and 1D (n2 = n3 = 1)
    grids.  Kernels A and B are held against their plain versions at each
    run's band block before it.  Returns the kernel launches of its runs
    and each kernel's max_abs_err at each run's shapes."""
    with open(os.path.join(HERE, "tests", "data", "torch_port_terms.json")) as f:
        ref = json.load(f)
    make = load_terms_cells()
    run = dict(launches={}, errs={})
    t0 = time.time()
    for name, fn in (("q1", lambda: terms_q1(dt, la, device, smi, run, ref["si54_q1"], make)),
                     ("q2", lambda: terms_q2(dt, la, device, smi, run, ref, make)),
                     ("q3", lambda: terms_q3(dt, la, device, smi, run, make)),
                     ("q4", lambda: terms_q4(dt, la, device, smi, run, ref, make))):
        t1 = time.time()
        fn()
        print(f"[q] {name}: {time.time() - t1:.1f} s ({smi})", flush=True)
    print(f"[q] phase q: {time.time() - t0:.1f} s; launches {run['launches']} ({smi})",
          flush=True)
    return run["launches"], run["errs"]


# ---------------------------------------------------------------------------
# r. postprocess, IO and utilities: the cells of
#    tests/data/make_torch_port_post.py (loaded, with the port as their
#    package), whose JAX values phase r1 reads
# ---------------------------------------------------------------------------

R_GAMMA_BAR = 1e-6            # r1: the path's Gamma against the SCF's Gamma (Ha)
R_BANDS_RESIDUAL_BAR = 1e-6   # r1: compute_bands' largest residual of the gated bands
R_JAX_BAR = 1e-7              # r1: the path's G, X, L against the JAX package's (Ha)
R_ELECTRONS_BAR = 0.1         # r1: the valence DOS's integral against 8 (tests/test_bands_dos.py)
R_LDOS_BAR = 1e-10            # r1: the LDOS's cell integral against the DOS (relative)
R_RESTART_BAR = 1e-10         # r4: the restarted SCF against the saved energy (Ha)
R_POSITION_BAR = 1e-3         # r3: the displaced atom back at its site (reduced)
R3 = dict(tol_force=1e-3, maxiter=20, scf_tol=1e-8)


def load_post_cells():
    """tests/data/make_torch_port_post.py as a module: its constructors take
    the package as an argument, and loading it imports nothing of JAX
    (checked here)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_post", os.path.join(HERE, "tests", "data", "make_torch_port_post.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dftk_tpu")],
          "phase r: loading the cells imported no JAX")
    return make


def post_r1(dt, la, device, smi, run, ref, make):
    """r1: examples/band_structure_dos.py's silicon: the SCF, the band
    structure along the fcc path, the DOS and LDOS, and the PDOS of its PBE
    UPF twin at Gamma's band edges.  Returns the SCF result."""
    import torch
    from dftk_tpu_torch.postprocess.dos import compute_pdos
    from dftk_tpu_torch.utils.timer import timer
    total = run["launches"]
    want = ref["r1"]
    basis = make.r1_basis(dt, device=device)
    check(list(basis.fft_size) == want["fft_size"] and basis.n_kpoints == want["n_kpoints"],
          "r1: the JAX package's basis")
    hold_kernels_at(la, basis, "r1 silicon", make.R1["n_bands"], run["errs"], tag="r")
    psi0 = torch.as_tensor(make.seeded_orbitals(basis.mask_np, make.R1["n_bands"] + 3, 14),
                           device=device)
    res = counted_run(la, smi, total, "r1 SCF", "r", lambda: dt.self_consistent_field(
        basis, tol=make.R1["tol"], n_bands=make.R1["n_bands"], psi=psi0))
    print(f"[r] r1 SCF: {res.n_iter} iterations, E = {res.total_energy:.12f}", flush=True)
    check(res.converged, "r1 SCF converged")
    held_against(smi, "r", "r1 SCF energy against JAX", res.total_energy, want["total_energy"],
                 E_TOL)
    t0 = dict(timer.totals)
    bands = counted_run(la, smi, total, "r1 compute_bands", "r", lambda: dt.compute_bands(
        res, n_bands=make.R1["n_bands"], kline_density=12))
    dt_ = {k: timer.totals[k] - t0.get(k, 0.0) for k in ("compute_bands basis",
                                                          "compute_bands lobpcg")}
    ev, kp = bands["eigenvalues"], bands["kpath"]
    print(f"[r] r1 compute_bands: {len(kp.kcoords)} k-points, basis build "
          f"{dt_['compute_bands basis']:.2f} s, LOBPCG {dt_['compute_bands lobpcg']:.2f} s "
          f"({bands['n_iter']} iterations, converged={bands['converged']}, largest residual "
          f"{bands['residual']:.2e}; {smi})", flush=True)
    # LOBPCG's stall rule (both packages: 6 steps without a 1% gain) may end
    # a path point whose last gated band sits by a cluster above the block
    # at ~5e-8 (the CPU's G-L point at 2/7: 4.6e-8); its eigenvalues are
    # then exact far below the bars
    check(bands["residual"] < R_BANDS_RESIDUAL_BAR, "r1 compute_bands' residuals")
    first = {}
    for i in sorted(kp.labels):
        first.setdefault(kp.labels[i], i)
    ik0 = int(np.argmin(np.linalg.norm(basis.kcoords, axis=1)))
    check(np.linalg.norm(basis.kcoords[ik0]) == 0, "r1: the SCF's grid holds Gamma")
    held_against(smi, "r", "r1 path Gamma against the SCF's Gamma", ev[first["G"]],
                 res.eigenvalues[ik0, :make.R1["n_bands"]], R_GAMMA_BAR)
    for name, k in make.R1_KPOINTS.items():
        check(np.allclose(kp.kcoords[first[name]], k), f"r1: {name} on the path")
        held_against(smi, "r", f"r1 path {name} against JAX", ev[first[name]],
                     np.array(want["eigenvalues"][name]), R_JAX_BAR)

    e = make.DOS_EPS
    eps = np.linspace(e["lo"], res.epsF, e["n"])
    dos = dt.compute_dos(eps, basis, res.eigenvalues, temperature=e["temperature"])
    n_el = float(np.trapezoid(dos, eps))
    print(f"[r] r1 valence DOS integral {n_el:.6f} (8 within {R_ELECTRONS_BAR})", flush=True)
    check(abs(n_el - 8.0) < R_ELECTRONS_BAR, "r1: the valence DOS integrates to 8")
    eps = res.epsF - np.array([0.05, 0.15, 0.3])
    ldos = dt.compute_ldos(eps, basis, res.eigenvalues, res.psi)
    dos = dt.compute_dos(eps, basis, res.eigenvalues)
    rel = float(np.abs(ldos.sum(axis=(1, 2, 3)) * basis.dvol - dos).max() / np.abs(dos).max())
    print(f"[r] r1 LDOS: {ldos.shape}, cell integral against the DOS {rel:.3e} relative",
          flush=True)
    check(np.isfinite(ldos).all() and rel < R_LDOS_BAR, "r1: the LDOS integrates to the DOS")

    pbe = dt.PlaneWaveBasis(make.si2_model(dt, functionals="PBE", psp=make.SI_UPF),
                            Ecut=make.R1["Ecut"], kgrid=make.R1["kgrid"], device=device)
    r_pbe = counted_run(la, smi, total, "r1 PBE UPF SCF", "r", lambda: dt.self_consistent_field(
        pbe, tol=1e-8, n_bands=make.R1["n_bands"]))
    ik0 = int(np.argmin(np.linalg.norm(pbe.kcoords, axis=1)))
    eps = np.array([r_pbe.eigenvalues[ik0, 0], r_pbe.eigenvalues[ik0, 3]])
    pdos = compute_pdos(eps, pbe, r_pbe.eigenvalues, r_pbe.psi)
    s = [sum(pdos[k][i] for k in pdos if "_l0_" in k) for i in (0, 1)]
    p = [sum(pdos[k][i] for k in pdos if "_l1_" in k) for i in (0, 1)]
    print(f"[r] r1 PDOS at Gamma's band bottom and top: s {s}, p {p}", flush=True)
    check(r_pbe.converged and len(pdos) == 4 and s[0] > p[0] and p[1] > s[1],
          "r1: the band bottom s-like, the top p-like")
    return res


def displaced_si54():
    """Phase i's Si54 (`tools/run_si_big.py::bench_model`) with atom 0 moved
    by DISPLACEMENT: (builder(positions) -> Model, the displaced positions,
    the ideal ones)."""
    from dftk_tpu_torch.tools.run_si_big import bench_model
    ideal = bench_model(3).positions
    positions = [p.copy() for p in ideal]
    positions[0] = positions[0] + np.array(DISPLACEMENT)
    return (lambda pos: bench_model(3, pos)), positions, ideal


def post_r2(dt, la, device, smi, run):
    """r2: the two-grid refinement of the displaced Si54 (Ecut 10 -> 15)
    against a full Ecut-15 SCF (tests/test_refine_chefsi.py's claims)."""
    from dftk_tpu_torch.response import chi0 as chi0_mod
    total = run["launches"]
    builder, positions, _ = displaced_si54()
    model = builder(positions)
    coarse = dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)
    res_c = counted_run(la, smi, total, "r2 SCF at Ecut 10", "r", lambda: dt.self_consistent_field(
        coarse, tol=1e-10))
    check(res_c.converged, "r2 coarse SCF converged")
    ref_, fr = counted_run(la, smi, total, "r2 refine_scfres and refine_forces", "r", lambda: (
        lambda r: (r, dt.refine_forces(r)))(dt.refine_scfres(res_c, Ecut_fine=15.0)))
    print(f"[r] r2 refinement to {ref_.basis}: Omega + K CG steps "
          f"{chi0_mod.counts.steps['omega_plus_k']}", flush=True)
    fine = dt.PlaneWaveBasis(model, Ecut=15.0, kgrid=(1, 1, 1), device=device)
    check(fine.fft_size == ref_.basis.fft_size, "r2: the refinement's fine grid")
    hold_kernels_at(la, fine, "r2 Si54 Ecut 15", model.default_n_bands(), run["errs"], tag="r")
    res_f = counted_run(la, smi, total, "r2 SCF at Ecut 15", "r", lambda: dt.self_consistent_field(
        fine, tol=1e-10))
    check(res_f.converged, "r2 fine SCF converged")
    F_f = dt.compute_forces(res_f).cpu().numpy()
    F_c = dt.compute_forces(res_c).cpu().numpy()
    err_E = abs(res_c.total_energy - res_f.total_energy)
    err_E_ref = abs(ref_.total_energy - res_f.total_energy)
    err_F = float(np.abs(F_c - F_f).max())
    err_F_ref = float(np.abs(fr["F_refined"] - F_f).max())
    print(f"[r] r2 energy error: coarse {err_E:.3e}, refined {err_E_ref:.3e} Ha; forces "
          f"error: coarse {err_F:.3e}, transferred {float(np.abs(fr['F'] - F_f).max()):.3e}, "
          f"refined {err_F_ref:.3e} Ha/bohr ({smi})", flush=True)
    check(err_E_ref < err_E / 3, "r2: the refined energy's error under a third of the coarse's")
    check(err_F_ref < err_F, "r2: the refined forces' error under the coarse forces'")


def post_r3(dt, la, device, smi, run):
    """r3: the displaced Si54 relaxed by optimize_geometry."""
    total = run["launches"]
    builder, positions, ideal = displaced_si54()
    t0 = time.time()
    out = counted_run(la, smi, total, "r3 optimize_geometry", "r", lambda: dt.optimize_geometry(
        builder, positions, Ecut=10.0, kgrid=(1, 1, 1), tol_force=R3["tol_force"],
        maxiter=R3["maxiter"], scf_kwargs=dict(tol=R3["scf_tol"]), device=device))
    wall = time.time() - t0
    traj = out["trajectory"]
    d = np.array(out["positions"]) - np.array(ideal)
    d -= np.round(d)
    off = d[0] - d[1:].mean(axis=0)
    print(f"[r] r3: {out['n_scf']} SCFs in {wall:.2f} s ({wall / out['n_scf']:.2f} s each), "
          f"E {traj[0][0]:.10f} -> {out['energy']:.10f}, max|F| {traj[0][1]:.3e} -> "
          f"{np.abs(out['forces']).max():.3e}, atom 0 off its site by {np.abs(off).max():.2e} "
          f"(start {np.abs(np.array(DISPLACEMENT)).max():.0e}; {smi})", flush=True)
    check(out["converged"], "r3 relaxation converged")
    check(out["energy"] < traj[0][0], "r3: the energy fell")
    check(np.abs(off).max() < R_POSITION_BAR, "r3: atom 0 back at its site")


def post_r4(dt, la, device, smi, run, res1, si54, make):
    """r4: checkpoints (phase c's Si54 split result and r1's SCF) saved and
    loaded, r1's SCF restarted from its file; the .vts of r1's density, the
    Wannier90 files of r1's silicon on the full grid; the calculator's
    state reuse at Si2."""
    import torch
    from dftk_tpu_torch.external import wannier
    from dftk_tpu_torch.external.calculator import DFTCalculator
    total = run["launches"]
    out_dir = os.path.join(HERE, "build", "chip_smoke_r4")
    os.makedirs(out_dir, exist_ok=True)
    basis_c, res_c = si54
    fn = os.path.join(out_dir, "si54_split.npz")
    dt.save_scfres(fn, res_c)
    loaded = dt.load_scfres(fn, device=device)
    check(loaded["basis"].fft_size == basis_c.fft_size
          and loaded["psi"].shape == tuple(res_c["U"].shape)
          and loaded["energies"] == res_c["energies"], "r4: the split result loads back")
    fn = os.path.join(out_dir, "si2_r1.npz")
    dt.save_scfres(fn, res1)
    loaded = dt.load_scfres(fn, device=device)
    b = loaded["basis"]
    check(b.fft_size == res1.basis.fft_size and len(b.symmetries) == len(res1.basis.symmetries),
          "r4: r1's basis rebuilt")
    res = counted_run(
        la, smi, total, "r4 restart from r1's file", "r", lambda: dt.self_consistent_field(
            b, tol=make.R1["tol"], n_bands=make.R1["n_bands"],
            rho=torch.as_tensor(loaded["rho"], device=device),
            psi=torch.as_tensor(loaded["psi"], device=device)))
    dE = res.total_energy - loaded["energies"]["total"]
    print(f"[r] r4 restart: {res.n_iter} iterations, E diff {dE:.3e} Ha", flush=True)
    check(res.converged and res.n_iter <= 3 and abs(dE) < R_RESTART_BAR,
          "r4: the restart converges within 3 iterations at the saved energy")
    fn = os.path.join(out_dir, "si2_r1.vts")
    dt.save_scfres(fn, res1)
    with open(fn) as f:
        head = f.read(400)
    check("StructuredGrid" in head and os.path.getsize(fn) > 0, "r4: the .vts written")
    full = dt.unfold_bz(res1)
    files = wannier.write_wannier90_files(os.path.join(out_dir, "si"), full, n_wann=4, bands=4)
    lines = open(files["mmn"]).read().splitlines()
    nb, nk, nnb = map(int, lines[1].split())
    vals = np.array([[float(x) for x in ln.split()] for ln in lines[2:] if len(ln.split()) == 2])
    mag = np.hypot(vals[:, 0], vals[:, 1])
    print(f"[r] r4 Wannier90: {nk} k-points, {nnb} neighbours, {len(vals)} overlaps, "
          f"max |M| {mag.max():.6f}", flush=True)
    check((nb, nk) == (4, full.basis.n_kpoints) and nnb >= 6 and np.isfinite(mag).all()
          and mag.max() <= 1 + 1e-6, "r4: the Wannier90 overlaps")

    def cbuilder(lattice, positions):
        return make.si2_model(dt, positions=positions)

    calc = DFTCalculator(cbuilder, Ecut=5.0, kgrid=(1, 1, 1), device=device,
                         scf_kwargs=dict(tol=1e-7, maxiter=40))
    E1 = calc.potential_energy(make.SI_LATTICE, make.SI_POSITIONS)
    F1 = calc.forces(make.SI_LATTICE, make.SI_POSITIONS)
    calls1 = calc.n_scf_calls
    E2 = calc.potential_energy(make.SI_LATTICE, [make.SI_POSITIONS[0] + 0.01,
                                                 make.SI_POSITIONS[1]])
    print(f"[r] r4 calculator: E1 {E1:.10f}, E2 {E2:.10f}, SCF calls {calls1} then "
          f"{calc.n_scf_calls}", flush=True)
    check(calls1 == 1 and calc.n_scf_calls == 2 and E2 > E1 and F1.shape == (2, 3),
          "r4: the calculator reuses its state")


def post_phase(dt, la, device, smi, si54):
    """Phase r: what a user does after an SCF, on the card: r1 the band
    structure, DOS, LDOS and PDOS of silicon; r2 the two-grid refinement
    of the displaced Si54 with its refined forces; r3 its relaxation; r4
    checkpoints, the .vts and Wannier90 exports and the calculator.  Kernels
    A and B are held against their plain versions at r1's and r2's fine
    shapes.  si54: phase c's (basis, split result).  The sections are timed
    on the port's timer (CUDA events).  Returns the kernel launches of
    r1-r3 and each kernel's max_abs_err at each run's shapes."""
    from dftk_tpu_torch.utils.timer import timer
    with open(os.path.join(HERE, "tests", "data", "torch_port_post.json")) as f:
        ref = json.load(f)
    make = load_post_cells()
    run = dict(launches={}, errs={})
    timer.reset()
    t0 = time.time()
    out = {}
    for name, fn in (("r1", lambda: out.setdefault("res1", post_r1(dt, la, device, smi, run,
                                                                     ref, make))),
                     ("r2", lambda: post_r2(dt, la, device, smi, run)),
                     ("r3", lambda: post_r3(dt, la, device, smi, run))):
        t1 = time.time()
        with timer.section(f"phase {name}"):
            fn()
        print(f"[r] {name}: {time.time() - t1:.1f} s ({smi})", flush=True)
    launches = dict(run["launches"])
    check(launches.get("pruned_axis_dft", 0) > 0 and launches.get("local_plane", 0) > 0,
          "phase r1-r3: kernels A and B complex128 launched")
    t1 = time.time()
    with timer.section("phase r4"):
        post_r4(dt, la, device, smi, run, out["res1"], si54, make)
    print(f"[r] r4: {time.time() - t1:.1f} s ({smi})", flush=True)
    print(f"[r] phase r: {time.time() - t0:.1f} s; launches r1-r3 {launches} ({smi})",
          flush=True)
    for line in timer.report().splitlines():
        print(f"[r] {line}", flush=True)
    return launches, run["errs"]


def main():
    import torch
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[1] nvidia-smi: {smi}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    sys.path.insert(0, HERE)
    import dftk_tpu_torch as dt
    from dftk_tpu_torch.kernels import local_apply as la
    with open(os.path.join(HERE, "tests", "data", "torch_port_si54.json")) as f:
        E_ref = json.load(f)["total_energy"]
    device = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    lib = la.library()
    print(f"[2] built {os.path.relpath(lib.path, HERE)} in "
          f"{lib.build_seconds:.1f} s", flush=True)
    for line in lib.log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[2] ptxas: {line.strip()}", flush=True)
    for kernel, opcode in (("local_plane_c128_kernel", "DMMA"),
                           ("local_plane_bf16_kernel", "HMMA"),
                           ("axis_dft_bf16_kernel", "HMMA")):
        for name, count in sass_counts(lib.path, kernel, opcode).items():
            print(f"[2] SASS: {count} {opcode} instructions in {name}", flush=True)

    # ---- 3. kernels against their plain versions ---------------------------
    t0 = time.time()
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    basis = build_bench_basis(3, 10.0, device)
    print(f"[3] {basis} set up in {time.time() - t0:.1f} s", flush=True)
    m, n = basis.pruned.m_shape, basis.fft_size
    timings, inputs = kernel_phase(la, basis, device)

    # ---- 4. the LOBPCG SCF on the GPU ----------------------------------------
    def show(info):
        print(f"[4] it={info['n_iter']:3d} E={info['E']:.12f} "
              f"drho={info['drho']:.3e} eig_it={info['eig_iters']} "
              f"t={time.time() - t0:.1f}s", flush=True)

    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field(basis, tol=1e-8, is_converged="density",
                                   callback=show)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    dE = res.total_energy - E_ref
    print(f"[4] SCF converged={res.converged} n_iter={res.n_iter} wall={wall:.2f} s "
          f"E={res.total_energy:.12f} E_ref={E_ref:.12f} dE={dE:.3e} "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(res.converged, "SCF converged")
    check(np.isfinite(res.total_energy) and abs(dE) < E_TOL, f"|E - E_ref| < {E_TOL}")
    check(tuple(res.rho.shape) == (1,) + basis.fft_size
          and bool(torch.isfinite(res.rho).all()), "finite density of grid shape")
    check(launches["pruned_axis_dft"] > 0 and launches["local_plane"] > 0,
          "every complex128 kernel launched in the SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the SCF")
    del res

    # ---- a. the bf16 kernels ---------------------------------------------------
    timings.update(bf16_phase(la, basis, device, inputs))

    # ---- b. the compact-resident filter chain -----------------------------------
    filter_chain_phase(dt, la, basis, device)

    # ---- c. the split CheFSI SCF on Si54 (this slice's main path) -------------
    launches, E_c, res_c = split_scf_phase(dt, la, basis, E_ref)
    si54 = (basis, res_c)           # phase o's split adapters start from this state
    del basis, res_c
    torch.cuda.empty_cache()

    # ---- d. Si256 ---------------------------------------------------------------
    si256_phase(dt, la, device)
    torch.cuda.empty_cache()

    # ---- e. the filter-stage probes -----------------------------------------------
    probe_timings, probe_launches = probe_phase(device)

    # ---- f. the planar chain and the band-major fused chain ------------------
    fused_timings, fused_launches = fused_probe_phase(device)

    # ---- g. the fused-local-apply op probes -------------------------------------
    op_timings, op_launches = op_probe_phase(device)

    # ---- h. the Mosaic op probes ------------------------------------------------
    mosaic_timings, mosaic_launches = mosaic_phase(device)

    # ---- i. forces and stresses on the card --------------------------------------
    derivatives_phase(dt, la, device, smi)
    torch.cuda.empty_cache()

    # ---- j. crystal symmetry: the default model on the card --------------------
    sym_launches, sym_errs = symmetry_phase(dt, la, device, smi)
    for name, count in sym_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- k. metals, collinear spin and GGA ---------------------------------------
    metal_launches, metal_errs = metals_phase(dt, la, device, smi)
    for name, count in metal_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- l. UPF, NLCC and meta-GGA -------------------------------------------------
    mgga_launches, mgga_errs = mgga_phase(dt, la, device, smi, E_c)
    for name, count in mgga_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- m. the other SCF solvers and the response core ----------------------------
    solver_launches, solver_errs = solvers_phase(dt, la, device, smi)
    for name, count in solver_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- n. Gamma phonons and the elastic response --------------------------------
    phonon_launches, phonon_errs = phonon_phase(dt, la, device, smi)
    for name, count in phonon_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- o. phonons at q and the split response adapters -------------------
    q_launches, q_errs = q_phonon_phase(dt, la, device, smi, si54)
    for name, count in q_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- p. exact exchange and DFT+U ------------------------------------------------
    exx_launches, exx_errs = exx_phase(dt, la, device, smi)
    for name, count in exx_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- q. the model Hamiltonians' terms -------------------------------------------
    terms_launches, terms_errs = terms_phase(dt, la, device, smi)
    for name, count in terms_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()

    # ---- r. postprocess, IO and utilities ---------------------------------------------
    post_launches, post_errs = post_phase(dt, la, device, smi, si54)
    for name, count in post_launches.items():
        launches[name] += count
    del si54

    # ---- 5. results ---------------------------------------------------------
    x_shape, t_shape = (1, N_BANDS_KERNEL) + m, (1, N_BANDS_KERNEL, n[2], m[0], m[1])
    work = {"pruned_axis_dft": (axis_dft_work(x_shape, m[2], n[2], 16), "complex128"),
            "local_plane": (local_plane_work(t_shape, n[0], n[1], 16), "complex128"),
            "pruned_axis_dft[bf16]": (axis_dft_work(x_shape, m[2], n[2], 8), "bf16"),
            "local_plane[bf16]": (local_plane_work(t_shape, n[0], n[1], 8), "bf16")}
    kernels = []
    for name, (src, rep) in SOURCES.items():
        bound_ms, bound_by = bound(*work[name])
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=launches[name],
                            max_abs_err=timings[name]["max_abs_err"],
                            ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=timings[name].get("library_ms"),
                            device_ms=timings[name]["device_ms"],
                            max_abs_err_phase_j=sym_errs[name],
                            max_abs_err_phase_k=metal_errs[name],
                            max_abs_err_phase_l=mgga_errs[name],
                            **({"max_abs_err_phase_m": solver_errs[name]}
                               if name in solver_errs else {}),
                            **({"max_abs_err_phase_n": phonon_errs[name]}
                               if name in phonon_errs else {}),
                            **({"max_abs_err_phase_o": q_errs[name]}
                               if name in q_errs else {}),
                            **({"max_abs_err_phase_p": exx_errs[name]}
                               if name in exx_errs else {}),
                            **({"max_abs_err_phase_q": terms_errs[name]}
                               if name in terms_errs else {}),
                            **({"max_abs_err_phase_r": post_errs[name]}
                               if name in post_errs else {})))
    for name, rep in PROBE_REPLACES.items():
        r = probe_timings[name]
        kernels.append(dict(name=name, route="cuda", source=PROBE_SOURCE, replaces=rep,
                            launches=probe_launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    for name, (src, rep) in FUSED_SOURCES.items():
        r = fused_timings[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=fused_launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    for name, rep in OP_REPLACES.items():
        r = op_timings[name]
        kernels.append(dict(name=name, route="cuda", source=OP_SOURCE, replaces=rep,
                            launches=op_launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            per_launch_ms=r["per_launch_ms"], device_ms=r["device_ms"]))
    from dftk_tpu_torch.kernels import op_probes, op_speed
    for names, src, tool, lines in (
            (op_probes.MOSAIC_NAMES, OP_SOURCE, "probe_mosaic_ops", MOSAIC_OPS_LINES),
            (op_speed.NAMES, SPEED_SOURCE, "probe_mosaic_speed", MOSAIC_SPEED_LINES)):
        for name, line in zip(names, lines):
            r = mosaic_timings[name]
            kernels.append(dict(name=name, route="cuda", source=src,
                                replaces=f"tools/{tool}.py:{line}",
                                launches=mosaic_launches[name], max_abs_err=r["max_abs_err"],
                                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                bound_by=r["bound_by"], library_ms=r["library_ms"],
                                per_launch_ms=r["per_launch_ms"], device_ms=r["device_ms"]))
    check(len(kernels) == 42, f"42 kernels entries, got {len(kernels)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
