"""Parameter counts of every model of the port's table.

The counterpart of the repository's ``scripts/cal_params.py``: each name of
``models/__init__.py::MODELS`` (the JAX registry's names, in its sorted
order) built with its defaults, its parameters counted (BatchNorm
statistics are buffers, as flax keeps them out of ``params``).

Usage::

    python -m prior_diffuse_tpu_torch.scripts.cal_params
"""

from __future__ import annotations


def counts() -> dict:
    """``{name: parameter count}`` for every model of the table."""
    from prior_diffuse_tpu_torch.models import MODELS

    return {name: sum(p.numel() for p in MODELS[name]().parameters())
            for name in sorted(MODELS)}


def main(argv=None) -> dict:
    out = counts()
    for name, n in out.items():
        print(f"{name:28s} {n:>12,d} params")
    return out


if __name__ == "__main__":
    main()
