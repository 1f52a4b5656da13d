"""The research drivers on top of the port, one module for each of the
repository's ``scripts/*.py`` under the same name, each run as

    python -m prior_diffuse_tpu_torch.scripts.<name> ...

``train_demo`` (the staged convergence run), ``eval_schedules`` (quality
against latency per sampler schedule), ``diagnose_ddpm`` (the residual
DDPM's health), ``probe_predictability`` (a supervised regressor of the
residual), and the small analysis scripts ``cal_metrics``, ``cal_params``,
``analyze_residual``, ``draw``, ``gaussian_distribution`` and
``show_wav_len``.  They use the port's trainer, serving and metrics APIs
only.  Every output lies under ``--assets`` (or a path the caller names),
never in the repository; the drivers that train or serve run on the card
unless ``--device cpu`` is given.
"""
