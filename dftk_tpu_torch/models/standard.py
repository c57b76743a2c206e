"""Standard model constructors (reference `src/standard_models.jl`).

Port of `model_atomic`, `model_DFT`, `LDA`, `PBE` and `PBEsol` from
`dftk_tpu/models/standard.py`.
"""
from ..ops.terms import (AtomicLocal, AtomicNonlocal, Entropy, Ewald, Hartree,
                         Kinetic, PspCorrection, Xc)
from .model import Model


def _base_terms(temperature):
    terms = [Kinetic(), AtomicLocal(), AtomicNonlocal(), Ewald(),
             PspCorrection(), Hartree()]
    if temperature and temperature > 0:
        terms.append(Entropy())
    return terms


def model_atomic(lattice, atoms, positions, temperature=0.0, extra_terms=(), **kwargs):
    """The base terms without an XC term (Hartree included, as in the JAX
    package)."""
    terms = _base_terms(temperature) + list(extra_terms)
    return Model(lattice=lattice, atoms=list(atoms), positions=list(positions),
                 temperature=temperature, term_types=terms, **kwargs)


def model_DFT(lattice, atoms, positions, functionals="LDA", temperature=0.0,
              extra_terms=(), **kwargs):
    terms = _base_terms(temperature) + [Xc(_as_names(functionals))] \
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
