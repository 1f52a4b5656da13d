"""The serving path: RMS-normalised padded wavs in, enhanced wavs out.

``Enhancer.enhance_batch`` runs the steps of the JAX package's
``ComplexDDPMTrainer.enhance_batch`` (``training/ddpm_trainer.py``) in the
same order, in float32, without a trainer:

1. STFT 320/160 (K1) and magnitude compression;
2. one ``DiffUNet`` forward gives ``x_init``, divided by ``c``;
3. with ``sigma``, the PriorGrad mask of ``x_init``;
4. the reverse chain of ``DiffUNet1`` forwards (6 on the fast schedule),
   ``x_init`` added back;
5. multiply by ``c``, decompress, ISTFT (K2) to the input length.

Every encoder stage of the 7 forwards is K3, on operands packed from the
current weights (repacked whenever a parameter or BN statistic changes).
Steps 2-4 are :meth:`Enhancer.chain`, which the trainer's evaluation
runs on its spectra too.
"""

from __future__ import annotations

from typing import Optional

import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig
from prior_diffuse_tpu_torch.diffusion.qsample import sigma_mask
from prior_diffuse_tpu_torch.diffusion.sampler import is_noiseless, reverse_sample
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.ops.cuda.convblock import pack_encoder
from prior_diffuse_tpu_torch.signal.compress import decompress_spec
from prior_diffuse_tpu_torch.training.base import spec_features


class Enhancer:
    """Serve a ``DiffUNet`` prior and a ``DiffUNet1`` residual DDPM
    (pirorgrad mode) on ``device``; ``sigma`` turns on the PriorGrad mask."""

    def __init__(self, dis, ddpm, cfg: ExperimentConfig = ExperimentConfig(),
                 device="cuda", sigma: bool = False):
        diff, train = cfg.diffusion, cfg.train
        if not diff.pirorgrad:
            raise ValueError("the port serves the pirorgrad mode only")
        if diff.predict not in ("eps", "x0"):
            raise ValueError(f"unknown predict {diff.predict!r}")
        if (train.fft_num, train.win_size, train.win_shift) != (320, 320, 160):
            raise ValueError("the STFT kernels implement the 320/160 framing only")
        # f32 means f32: cuDNN runs float32 convolutions in TF32 (about
        # three significant digits) by default, while the JAX reference
        # computes its convolutions in f32 and its DFT at HIGHEST precision.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.sigma = sigma
        self.device = torch.device(device)
        self.dis = dis.to(self.device).eval()
        self.ddpm = ddpm.to(self.device).eval()
        self.sched = inference_schedule(diff)
        self._pack_key = None
        self._packs = None

    def packed_encoders(self):
        """K3 operands of both encoders, repacked when a weight changed
        (an in-place update bumps the tensor's version counter)."""
        key = tuple((t.data_ptr(), t._version)
                    for m in (self.dis, self.ddpm)
                    for t in [*m.core.en.parameters(), *m.core.en.buffers()])
        if key != self._pack_key:
            with torch.no_grad():
                self._packs = (pack_encoder(self.dis.core.en),
                               pack_encoder(self.ddpm.core.en))
            self._pack_key = key
        return self._packs

    @torch.no_grad()
    def enhance_batch(self, wav, generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``wav [B, L]`` (RMS-normalised, padded) -> enhanced ``[B, L]``.

        The chain's initial draws ``x_T [n_avg, B, T, 161, 2]`` (and step
        noise, for a schedule that has any) come from ``generator``, a
        ``torch.Generator`` on this device, unless ``x_T`` is given."""
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device).contiguous()
        est, _ = self.chain(spec_features(wav, self.cfg.train), generator, x_T)
        spec = decompress_spec(est, self.cfg.train.feat_type)
        return kstft.istft(spec.contiguous(), wav.shape[-1])

    @torch.no_grad()
    def chain(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None,
              x_T: Optional[torch.Tensor] = None):
        """Compressed noisy spectrum ``feat [B, T, 161, 2]`` -> ``(estimate,
        x_init)``: the prior, the sigma mask and the reverse chain, with the
        estimate scaled back by ``c`` (the compressed clean spectrum) and
        ``x_init`` the prior's output divided by ``c``."""
        diff = self.cfg.diffusion
        c = diff.scale_c
        self.dis.eval()
        self.ddpm.eval()
        pack_dis, pack_ddpm = self.packed_encoders()
        x_init = self.dis(feat, packed=pack_dis) / c
        sig = sigma_mask(x_init) if self.sigma else None
        cond = (torch.cat([x_init, feat / c], dim=-1) if diff.cond_noisy
                else x_init)

        shape = tuple(x_init.shape)
        noise = None
        if not is_noiseless(self.sched):
            noise = self._draw((diff.n_avg, self.sched.num_steps, *shape), generator)
        if x_T is None and not diff.zero_init:
            x_T = self._draw((diff.n_avg, *shape), generator)

        audio = reverse_sample(
            lambda x, t: self.ddpm(x, cond, t, packed=pack_ddpm),
            x_init, x_T, self.sched, sig_mask=sig, noise=noise,
            zero_init=diff.zero_init, predict=diff.predict)
        return audio * c, x_init

    def _draw(self, shape, generator):
        if generator is None:
            raise ValueError("pass a torch.Generator: the chain draws random numbers")
        return torch.randn(shape, generator=generator, device=self.device)
