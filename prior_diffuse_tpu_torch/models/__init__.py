"""The model zoo: the DiffUNet family (the DiffUNet prior and the DDPM
denoisers DiffUNet1 and Nocon), GCRN and the four DB-AIAT variants.

:data:`MODELS` maps the names of the JAX package's model registry
(``prior_diffuse_tpu/registry.py``), the names ``conf/*.yml`` gives under
``model.name``, to the port's classes; :func:`model_class` looks one up.
"""

from prior_diffuse_tpu_torch.models.dbaiat import (AiaComplexTransMag, AiaComplexTransRI,
                                                   DualAiaComplexTrans, DualAiaTransMergeCRM)
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1, Nocon
from prior_diffuse_tpu_torch.models.gcrn import GCRN

MODELS = {
    "DiffUNet": DiffUNet,
    "DiffUNet1": DiffUNet1,
    "Nocon": Nocon,
    "GCRN": GCRN,
    "aia_complex_trans_ri": AiaComplexTransRI,
    "aia_complex_trans_mag": AiaComplexTransMag,
    "dual_aia_complex_trans": DualAiaComplexTrans,
    "dual_aia_trans_merge_crm": DualAiaTransMergeCRM,
    # registered in the JAX package, not ported yet
    "GRN": None,
    "DiffWave": None,
}

_ITEM = {"GRN": "10b", "DiffWave": "10d"}


def model_class(name: str):
    """The port's class of the model registered as ``name``."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; registered: {', '.join(sorted(MODELS))}")
    if MODELS[name] is None:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item {_ITEM[name]})")
    return MODELS[name]
