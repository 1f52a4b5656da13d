"""The model zoo: the DiffUNet family (the DiffUNet prior and the DDPM
denoisers DiffUNet1 and Nocon), the complex priors GCRN and the four
DB-AIAT variants, the magnitude prior GRN and the waveform model DiffWave.

:data:`MODELS` maps the names of the JAX package's model registry
(``prior_diffuse_tpu/registry.py``), the names ``conf/*.yml`` gives under
``model.name``, to the port's classes; :func:`model_class` looks one up,
:func:`complex_prior_class` one that takes a complex spectrum and
:func:`magnitude_prior_class` one that takes a magnitude.
"""

from prior_diffuse_tpu_torch.models.dbaiat import (AiaComplexTransMag, AiaComplexTransRI,
                                                   DualAiaComplexTrans, DualAiaTransMergeCRM)
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1, Nocon
from prior_diffuse_tpu_torch.models.diffwave import DiffWave
from prior_diffuse_tpu_torch.models.gcrn import GCRN
from prior_diffuse_tpu_torch.models.grn import GRN

MODELS = {
    "DiffUNet": DiffUNet,
    "DiffUNet1": DiffUNet1,
    "Nocon": Nocon,
    "GCRN": GCRN,
    "aia_complex_trans_ri": AiaComplexTransRI,
    "aia_complex_trans_mag": AiaComplexTransMag,
    "dual_aia_complex_trans": DualAiaComplexTrans,
    "dual_aia_trans_merge_crm": DualAiaTransMergeCRM,
    "GRN": GRN,
    "DiffWave": DiffWave,
}

# models of the table that take no complex spectrum, and what takes them
_NOT_COMPLEX = {
    "GRN": "a magnitude model ([B, T, 161]): train it with --trainer MagTrainer",
    "DiffWave": "a waveform model ([B, L]): no trainer of the JAX package uses it",
}


def model_class(name: str):
    """The port's class of the model registered as ``name``."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; registered: {', '.join(sorted(MODELS))}")
    return MODELS[name]


def complex_prior_class(name: str):
    """:func:`model_class` of a prior that maps a complex spectrum ``[B, T,
    161, 2]`` to one, as ``ComplexTrainer`` and ``ComplexDDPMTrainer`` take
    it; ``GRN`` and ``DiffWave`` raise ``ValueError``."""
    cls = model_class(name)
    if name in _NOT_COMPLEX:
        raise ValueError(f"model {name!r} is not a complex-spectrum prior: "
                         f"{_NOT_COMPLEX[name]}")
    return cls


def magnitude_prior_class(name: str):
    """:func:`model_class` of a prior that maps a compressed magnitude
    ``[B, T, 161]`` to one, as ``MagTrainer`` takes it: ``GRN``; any other
    model raises ``ValueError``."""
    cls = model_class(name)
    if cls is not GRN:
        raise ValueError(f"model {name!r} is not a magnitude prior: MagTrainer trains GRN")
    return cls
