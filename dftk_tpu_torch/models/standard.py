"""Standard model constructors (reference `src/standard_models.jl`).

Port of `model_atomic`, `model_DFT`, `LDA`, `PBE`, `PBEsol`, the hybrids
`PBE0` and `HSE06`, and `model_HF` from `dftk_tpu/models/standard.py`;
`model_atomic` and `model_DFT` take a `kinetic_blowup` (`BlowupCHV`,
`BlowupAbinit`, `BlowupIdentity` or None) for their Kinetic term.
"""
from ..ops.terms import (AtomicLocal, AtomicNonlocal, Entropy, Ewald, ExactExchange,
                         Hartree, Kinetic, PspCorrection, Xc)
from .model import Model


def _base_terms(temperature, kinetic_blowup=None):
    terms = [Kinetic(blowup=kinetic_blowup), AtomicLocal(), AtomicNonlocal(), Ewald(),
             PspCorrection(), Hartree()]
    if temperature and temperature > 0:
        terms.append(Entropy())
    return terms


def model_atomic(lattice, atoms, positions, temperature=0.0, extra_terms=(),
                 kinetic_blowup=None, **kwargs):
    """The base terms without an XC term (Hartree included, as in the JAX
    package)."""
    terms = _base_terms(temperature, kinetic_blowup) + list(extra_terms)
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 temperature=temperature, term_types=terms, **kwargs)


def model_DFT(lattice, atoms, positions, functionals="LDA", temperature=0.0,
              extra_terms=(), kinetic_blowup=None, **kwargs):
    terms = _base_terms(temperature, kinetic_blowup) + [Xc(_as_names(functionals))] \
        + list(extra_terms)
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 temperature=temperature, term_types=terms, **kwargs)


def _as_names(functionals):
    from ..ops.xc.functionals import FUNCTIONAL_SETS
    if isinstance(functionals, str):
        return FUNCTIONAL_SETS.get(functionals, (functionals,))
    return tuple(functionals)


def LDA(lattice, atoms, positions, **kwargs):
    return model_DFT(lattice, atoms, positions, functionals="LDA", **kwargs)


def PBE(lattice, atoms, positions, **kwargs):
    return model_DFT(lattice, atoms, positions, functionals="PBE", **kwargs)


def PBEsol(lattice, atoms, positions, **kwargs):
    return model_DFT(lattice, atoms, positions, functionals="PBEsol", **kwargs)


def PBE0(lattice, atoms, positions, **kwargs):
    """PBE0 hybrid: 0.75 PBE_x + PBE_c + 0.25 exact exchange."""
    terms = _base_terms(kwargs.get("temperature", 0.0)) + [
        Xc((("gga_x_pbe", 0.75), ("gga_c_pbe", 1.0))),
        ExactExchange(scaling_factor=0.25),
    ]
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 term_types=terms, **kwargs)


def HSE06(lattice, atoms, positions, omega=0.11, exx_fraction=0.25, **kwargs):
    """HSE06 screened hybrid (Heyd-Scuseria-Ernzerhof, erfc-split Coulomb):

      Exc = Ex_PBE - a * Ex_wPBE_SR(omega) + a * Ex_HF_SR(omega) + Ec_PBE

    with a = 0.25 and omega = 0.11 bohr^-1: the short-range semilocal
    exchange is the HJS omega-PBE hole model (`gga_x_wpbeh`), the
    short-range Fock term ExactExchange with an erfc-screened kernel.
    Reference: src/standard_models.jl:163-166."""
    from ..ops.coulomb import ShortRangeCoulomb
    from ..ops.xc.functionals import make_gga_x_wpbeh
    terms = _base_terms(kwargs.get("temperature", 0.0)) + [
        Xc((("gga_x_pbe", 1.0), (make_gga_x_wpbeh(omega), -exx_fraction),
            ("gga_c_pbe", 1.0))),
        ExactExchange(scaling_factor=exx_fraction, kernel=ShortRangeCoulomb(mu=omega)),
    ]
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 term_types=terms, **kwargs)


def model_HF(lattice, atoms, positions, **kwargs):
    """Hartree-Fock: no XC, full exact exchange."""
    terms = _base_terms(kwargs.get("temperature", 0.0)) + [ExactExchange(scaling_factor=1.0)]
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 term_types=terms, **kwargs)
