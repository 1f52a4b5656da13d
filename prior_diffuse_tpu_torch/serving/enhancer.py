"""The serving path: RMS-normalised padded wavs in, enhanced wavs out.

``Enhancer.enhance_batch`` runs the steps of the JAX package's
``ComplexDDPMTrainer.enhance_batch`` (``training/ddpm_trainer.py``) in the
same order, without a trainer, with the model compute in ``dtype``
(``serve_dtype``: float32, or bfloat16, the JAX package's fast path):

1. STFT 320/160 (K1, float32) and magnitude compression, then cast;
2. one prior forward gives ``x_init``, divided by ``c``: the packed
   ``DiffUNet`` (below), or any other complex prior of the model table
   (GCRN, the DB-AIAT variants) through the module forward of its
   :func:`serving_copy`, unpacked, as the JAX package serves it
   (``ddpm_trainer.py:599-612``);
3. with ``sigma``, the PriorGrad mask of ``x_init``;
4. the reverse chain of denoiser forwards (6 on the fast schedule) in
   ``dtype``, in the config's diffusion mode (``diffusion_mode``):
   ``pirorgrad`` (``DiffUNet1`` conditioned on ``x_init``, or with
   ``cond_noisy`` on ``[x_init, feat / c]``; ``x_init`` added back),
   ``deltamu`` (the unconditional ``Nocon``, the chain started at
   ``x_T + x_init``) or ``conditional`` (``DiffUNet1`` conditioned on the
   noisy spectrum ``feat / c``);
5. back to float32, multiply by ``c``, decompress, ISTFT (K2, float32) to
   the input length.

The UNet forwards are ``models/fused_forward.py::fused_unet_forward``:
every encoder stage of the 7 forwards (6 with another prior) is K3
(``enc_stage`` in float32,
``enc_stage_bf16`` in bfloat16), and the decoders are the two ``Decoder``
modules in float32 and the block-diagonal dual chain in bfloat16, the
routes ``_resolve_fused`` picks for an empty environment.  Operands are
packed from the current weights and repacked whenever a parameter or BN
statistic changes.  Steps 2-4 are
:meth:`Enhancer.chain`, which the trainer's evaluation runs on its
spectra too.

In bfloat16 on the card a batch is host-paced (thousands of short
launches), so there steps 1-5 run as one CUDA graph replay
(:class:`BatchGraph`): one graph per ``(rung, length)``, the batch's rows
padded with zeros to :func:`batch_rung`, captured from the same code at
the first batch of its shape, the draws taken eagerly at the batch's own
shape and copied into the graph's buffers, every graph dropped when the
packs are repacked.  float32 and the CPU run op by op
(:meth:`Enhancer.eager_batch`).

A model *trained* in bf16 (``train.compute_dtype: bfloat16``) is not served
so: :class:`ComputeEnhancer` runs it as the JAX package evaluates and serves
it by default (``serve_dtype`` float32): the prior and the denoiser as their
bf16-compute modules on the float32 weights (``models/precision.py``),
eval mode, two separate decoders, the chain in float32; K1 and K2 run, K3
does not (JAX's ``_resolve_fused`` picks the flax modules there).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from prior_diffuse_tpu_torch.config import ExperimentConfig
from prior_diffuse_tpu_torch.diffusion.qsample import sigma_mask
from prior_diffuse_tpu_torch.diffusion.sampler import (diffusion_mode, is_noiseless,
                                                       reverse_sample, rounded)
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet
from prior_diffuse_tpu_torch.models.fused_forward import fused_unet_forward, pack_unet
from prior_diffuse_tpu_torch.models.precision import compute_view
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.parallel.mesh import draw_rows
from prior_diffuse_tpu_torch.signal.compress import decompress_spec
from prior_diffuse_tpu_torch.signal.stft import frame_count
from prior_diffuse_tpu_torch.training.base import spec_features
from prior_diffuse_tpu_torch.utils.profiler import count, span


def weights_key(*modules) -> tuple:
    """A key that changes whenever a parameter or buffer of ``modules``
    is replaced or updated in place (an in-place update bumps the tensor's
    version counter): caches of operands derived from them compare it."""
    return tuple((t.data_ptr(), t._version)
                 for m in modules for t in [*m.parameters(), *m.buffers()])


# a graphed batch's rows are padded up to a multiple of ROW_RUNG (batch_rung)
ROW_RUNG = 4


def batch_rung(rows: int) -> int:
    """The rows of the graph that serves a batch of ``rows``: ``rows``
    rounded up to a multiple of :data:`ROW_RUNG` (over the recordings
    cell's pool the padding adds 4.4 % of the segment work, against 30
    graphs for the exact row counts)."""
    return -(-rows // ROW_RUNG) * ROW_RUNG


def upload_batch(wav, device: torch.device) -> torch.Tensor:
    """A host batch ``wav [B, L]`` on ``device``, float32 and contiguous."""
    with span("enh.upload"):
        return torch.as_tensor(wav, dtype=torch.float32).to(device).contiguous()


def serving_device(device) -> torch.device:
    """``device`` for a server: the card unless the caller asks for
    ``"cpu"``, and without a card that default raises.  It also turns TF32
    off: f32 means f32.  cuDNN runs float32 convolutions and RNNs in TF32
    (about three significant digits) by default, while the JAX reference
    computes them in f32 and its DFT at HIGHEST precision."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port serves on the card unless "
                           "device='cpu' is passed")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


class _ProductThenBias(nn.Module):
    """A conv or linear layer of a serving copy below float32 as flax
    computes it there: the product rounded to the dtype, then the bias
    added and the sum rounded again (torch's fused bias rounds once)."""

    def __init__(self, product: nn.Module):
        super().__init__()
        self.bias = product.bias
        product.bias = None
        self.product = product
        self._channel_first = not isinstance(product, nn.Linear)

    def forward(self, x):
        y = self.product(x)
        return y + (self.bias.view(-1, *(1,) * (y.ndim - 2)) if self._channel_first
                    else self.bias)


_PRODUCTS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _bias_apart(module: nn.Module) -> None:
    """Wrap every conv and linear layer with a bias under ``module`` (but
    not in its ``F32_PARTS``) in :class:`_ProductThenBias`."""
    for name, child in list(module.named_children()):
        if name in getattr(module, "F32_PARTS", ()):
            continue
        if isinstance(child, _PRODUCTS) and child.bias is not None:
            setattr(module, name, _ProductThenBias(child))
        else:
            _bias_apart(child)


def serving_copy(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``net`` for inference in ``dtype`` as the JAX package serves a prior
    in ``serve_dtype``: the net itself in float32; else a copy with every
    parameter and BN statistic cast to ``dtype`` (JAX casts its variables,
    ``ddpm_trainer.py:680-686``, ``serving/enhance.py:119-126``), whose
    ops then run in the promotion of their operands' dtypes.  Where JAX
    feeds a part float32 (GCRN's grouped LSTM, DB-AIAT's GRUs and the
    ``linear2`` after them), that part's ``F32_PARTS`` entry holds the
    ``dtype``-rounded weights in float32, as JAX promotes the bf16 weights
    to f32 there; the modules' forwards cast around those parts as JAX
    does (``tools/bf16_trace.py`` traces JAX's forward, PERF.md has the
    table).  cuDNN gets one flat weight buffer per RNN.  Each conv and
    linear layer in ``dtype`` rounds its product before adding its bias, as
    flax's do (:class:`_ProductThenBias`).  Inference only."""
    if dtype == torch.float32:
        return net
    out = copy.deepcopy(net).to(dtype).eval()
    for module in list(out.modules()):
        for name in getattr(module, "F32_PARTS", ()):
            for m in getattr(module, name).float().modules():
                if isinstance(m, nn.RNNBase):
                    m.flatten_parameters()
    _bias_apart(out)
    return out


class Enhancer:
    """Serve a prior (the ``DiffUNet``, or any other complex prior of the
    model table) and a DDPM denoiser (``DiffUNet1``, or ``Nocon`` in
    deltamu mode) on ``device`` in ``dtype``; ``sigma`` turns on the
    PriorGrad mask.  ``device`` is the card unless the caller asks for
    ``"cpu"``; without a card that default raises."""

    def __init__(self, dis, ddpm, cfg: ExperimentConfig = ExperimentConfig(),
                 device="cuda", sigma: bool = False, dtype: torch.dtype = torch.float32):
        diff, train = cfg.diffusion, cfg.train
        self.mode = diffusion_mode(diff)
        if (train.fft_num, train.win_size, train.win_shift) != (320, 320, 160):
            raise ValueError("the STFT kernels implement the 320/160 framing only")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the enhancer serves float32 or bfloat16, not {dtype}")
        self.device = serving_device(device)
        self.cfg = cfg
        self.sigma = sigma
        self.dtype = dtype
        self.dis = dis.to(self.device).eval()
        self.ddpm = ddpm.to(self.device).eval()
        self.sched = inference_schedule(diff)
        self._pack_key = None
        self._packs = None
        self._prior_copy = None
        # bfloat16 on the card: the batch graphs by (rung, length), the pack
        # key they were captured on, the memory pool they share and the
        # stream they are captured on (the caching allocator reuses a block
        # only on the stream that freed it: one stream lets each capture
        # reuse what the earlier ones freed)
        self._graphs = {}
        self._graphs_key = None
        self._graph_pool = None
        self._static_draws = None

    def packs(self):
        """``(prior, denoiser)`` operands of :func:`fused_unet_forward` in
        the enhancer's dtype, repacked when a weight changed
        (:func:`weights_key`); the prior's is None unless it is a
        ``DiffUNet`` (another prior's :func:`serving_copy` is made again
        with them).  The decoders are dual in every dtype but float32."""
        key = weights_key(self.dis, self.ddpm)
        if key != self._pack_key:
            dual = self.dtype != torch.float32
            packed = isinstance(self.dis, DiffUNet)
            self._packs = (pack_unet(self.dis, self.dtype, dual) if packed else None,
                           pack_unet(self.ddpm, self.dtype, dual))
            self._prior_copy = None if packed else serving_copy(self.dis, self.dtype)
            self._pack_key = key
            count("enh.repacks")
        return self._packs

    @torch.no_grad()
    def prior(self, feat: torch.Tensor) -> torch.Tensor:
        """The prior's estimate of the compressed spectrum ``feat [B, T,
        161, 2]`` in the enhancer's dtype: the packed ``DiffUNet``, or
        another prior's :func:`serving_copy` (its module forward)."""
        with span("enh.prior"):
            pack_dis, _ = self.packs()
            feat = feat.to(self.dtype)
            return (self._prior_copy(feat) if pack_dis is None
                    else fused_unet_forward(pack_dis, feat))

    @torch.no_grad()
    def enhance_batch(self, wav, generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``wav [B, L]`` (RMS-normalised, padded) -> enhanced ``[B, L]``
        float32.

        The chain's initial draws ``x_T [n_avg, B, T, 161, 2]`` (and step
        noise, for a schedule that has any) come from ``generator``, a
        ``torch.Generator`` on this device, in the enhancer's dtype, unless
        ``x_T`` is given (it is cast to that dtype).  A bfloat16 enhancer on
        the card replays the batch as a CUDA graph (:class:`BatchGraph`):
        the same operations on ``B`` rows padded to :func:`batch_rung`."""
        if self.dtype == torch.bfloat16 and self.device.type == "cuda":
            with span("enh.batch"):
                return self._graphed_batch(wav, generator, x_T)
        return self.eager_batch(wav, generator, x_T)

    @torch.no_grad()
    def eager_batch(self, wav, generator: Optional[torch.Generator] = None,
                    x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`enhance_batch` op by op on the batch's own rows, never
        through a graph: the path of float32 and of the CPU, and what an
        operation count or a kernels-against-plain-versions check runs."""
        with span("enh.batch"):
            return self._forward(upload_batch(wav, self.device), generator, x_T)

    def _forward(self, wav: torch.Tensor, generator, x_T) -> torch.Tensor:
        """The batch's device work on ``wav [B, L]`` already on the device:
        features, :meth:`chain`, ISTFT."""
        with span("enh.features"):
            feat = spec_features(wav, self.cfg.train)
        est, _ = self.chain(feat, generator, x_T)
        with span("enh.istft"):
            spec = decompress_spec(est, self.cfg.train.feat_type)
            return kstft.istft(spec.contiguous(), wav.shape[-1])

    def _graphed_batch(self, wav, generator=None, x_T=None) -> torch.Tensor:
        """:meth:`enhance_batch` through the graph of its rung and length:
        the draws taken eagerly at the batch's own shape (the generator
        advances as on the eager path), placed into the graph's static
        buffers, then one replay, or at a shape's first call its eager run
        and capture.  Every graph is dropped when the weights change."""
        self.packs()
        if self._pack_key != self._graphs_key:
            self._graphs, self._graphs_key, self._graph_pool = {}, self._pack_key, None
        rows, length = np.shape(wav)
        key = (batch_rung(rows), length)
        graph = self._graphs.get(key)
        fresh = graph is None
        if fresh:
            graph = self._graphs[key] = BatchGraph(self, *key)
        with span("enh.upload"):
            graph.load_wav(wav)
        graph.load_draws(*self._draws((rows, frame_count(length), kstft.FREQ, 2),
                                       generator, x_T))
        count("enh.graph_pad_rows", key[0] - rows)
        if fresh:
            count("enh.graph_captures")
            out = graph.capture()
        else:
            count("enh.graph_replays")
            with span("enh.replay", self.device):
                out = graph.replay()
        return out[:rows].clone()

    @torch.no_grad()
    def chain(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None,
              x_T: Optional[torch.Tensor] = None):
        """Compressed noisy spectrum ``feat [B, T, 161, 2]`` (float32) ->
        ``(estimate, x_init)``: the prior, the sigma mask and the reverse
        chain in the enhancer's dtype, the estimate back in float32 and
        scaled by ``c`` (the compressed clean spectrum), ``x_init`` the
        prior's output divided by ``c``, in the enhancer's dtype."""
        diff = self.cfg.diffusion
        dt = self.dtype
        c = rounded([diff.scale_c], dt)[0]
        self.dis.eval()
        self.ddpm.eval()
        _, pack_ddpm = self.packs()
        feat = feat.to(dt)
        # a DiffUNet through its packed forward (K3), any other prior unpacked
        x_init = self.prior(feat) / c
        sig = sigma_mask(x_init) if self.sigma else None
        cond = self.conditioner(feat, c, x_init)

        noise, x_T = self._draws(tuple(x_init.shape), generator, x_T)
        audio = reverse_sample(
            lambda x, t: fused_unet_forward(pack_ddpm, x, cond, t),
            x_init, x_T, self.sched, sig_mask=sig, noise=noise,
            zero_init=diff.zero_init, predict=diff.predict, mode=self.mode)
        return audio.float() * c, x_init

    # the trainer's evaluation runs the serving chain (in float32 the JAX
    # package's evaluation and serving agree)
    eval_chain = chain

    def conditioner(self, feat, c, x_init):
        """The DDPM's conditioner, JAX ``ComplexDDPMTrainer._cond``
        (``ddpm_trainer.py:238-247``), from the compressed noisy spectrum
        ``feat``: None for ``Nocon`` (deltamu), ``feat / c``
        (conditional), ``x_init`` (pirorgrad) or, with ``cond_noisy``, the
        concat of ``x_init`` and ``feat / c``."""
        if self.mode == "deltamu":
            return None
        if self.mode == "conditional":
            return feat / c
        return (torch.cat([x_init, feat / c], dim=-1) if self.cfg.diffusion.cond_noisy
                else x_init)

    def _draws(self, shape, generator, x_T):
        """The chain's step noise (None for a noiseless schedule) and initial
        draws ``x_T`` (drawn unless given, then cast) in the chain's dtype."""
        if self._static_draws is not None:  # a graph's forward reads its buffers
            for d in self._static_draws:
                if d is not None and tuple(d.shape[-4:]) != tuple(shape):
                    raise ValueError(f"the graph's draws are {tuple(d.shape)}, the chain "
                                     f"runs on {tuple(shape)}")
            return self._static_draws
        diff = self.cfg.diffusion
        noise = None
        if not is_noiseless(self.sched):
            noise = self._draw((diff.n_avg, self.sched.num_steps, *shape), generator, 2)
        if x_T is None and not diff.zero_init:
            x_T = self._draw((diff.n_avg, *shape), generator, 1)
        elif x_T is not None:
            x_T = x_T.to(device=self.device, dtype=self.dtype)
        return noise, x_T

    def _draw(self, shape, generator, batch_dim: int):
        """A normal draw of ``shape`` whose rows run along ``batch_dim``
        (inside a ``parallel.mesh.DataParallel``: this rank's rows of the
        global padded batch's draw)."""
        if generator is None:
            raise ValueError("pass a torch.Generator: the chain draws random numbers")
        return draw_rows(lambda s: torch.randn(s, generator=generator, device=self.device,
                                               dtype=self.dtype), shape, batch_dim)


class BatchGraph:
    """One CUDA graph of :meth:`Enhancer.enhance_batch`'s device work
    (features, prior, conditioner, chain, ISTFT) at ``rung`` rows of
    ``length`` samples, captured from the eager code itself: its static
    input ``wav``, its static draws (allocated at the first
    :meth:`load_draws`) and its static output.  The rows past a batch's
    are zeros in the input and the draws.  A replay runs no Python, so the
    kernel wrappers' ``.launches`` count the eager run and the capture, not
    the replays (a device trace sees the replayed kernels)."""

    def __init__(self, enhancer: Enhancer, rung: int, length: int):
        self.enhancer = enhancer
        self.rows = rung
        self.wav = torch.zeros((rung, length), dtype=torch.float32, device=enhancer.device)
        self.draws = None
        self.graph = None
        self.out = None

    def load_wav(self, wav) -> None:
        """Copy the batch ``wav [B, L]`` into the first ``B`` input rows and
        zero the rest."""
        src = torch.as_tensor(wav, dtype=torch.float32)
        self.wav[:src.shape[0]].copy_(src)
        self.wav[src.shape[0]:].zero_()

    def load_draws(self, noise: Optional[torch.Tensor], x_T: Optional[torch.Tensor]) -> None:
        """Copy the batch's draws (either None where the chain takes none)
        into the first rows of the static ones (rows along dimension 2 of
        ``noise``, 1 of ``x_T``, as :meth:`Enhancer._draws` draws them) and
        zero the rest."""
        if self.draws is None:
            self.draws = tuple(
                None if d is None else
                d.new_zeros((*d.shape[:dim], self.rows, *d.shape[dim + 1:]))
                for d, dim in ((noise, 2), (x_T, 1)))
        for buf, d, dim in zip(self.draws, (noise, x_T), (2, 1)):
            if (buf is None) != (d is None):
                raise ValueError("the batch's draws differ from the graph's")
            if d is None:
                continue
            head = buf.narrow(dim, 0, d.shape[dim])
            if head.shape != d.shape:
                raise ValueError(f"draws of {tuple(d.shape)} for a graph of "
                                 f"{tuple(buf.shape)}")
            head.copy_(d)
            buf.narrow(dim, d.shape[dim], self.rows - d.shape[dim]).zero_()

    def forward(self) -> torch.Tensor:
        """The eager device work on the static input and draws."""
        enh = self.enhancer
        enh._static_draws = self.draws
        try:
            return enh._forward(self.wav, None, None)
        finally:
            enh._static_draws = None

    def capture(self) -> torch.Tensor:
        """Run :meth:`forward` once eagerly on a side stream (lazy
        initialisation, cuDNN's choices), then capture it into the
        enhancer's shared memory pool, both on the enhancer's capture stream;
        returns the eager run's output."""
        enh = self.enhancer
        if enh._graph_pool is None:
            enh._graph_pool = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(enh.device))
        pool, side = enh._graph_pool
        side.wait_stream(torch.cuda.current_stream(enh.device))
        with torch.cuda.stream(side):
            out = self.forward()
        torch.cuda.current_stream(enh.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.out = self.forward()
        return out

    def replay(self) -> torch.Tensor:
        """Replay the graph; its static output, overwritten by the next."""
        self.graph.replay()
        return self.out


class ComputeEnhancer(Enhancer):
    """Evaluate and serve nets trained in ``compute_dtype`` (bf16 training)
    as the JAX package does by default (``ddpm_trainer.py:363-384`` and
    ``:574-654`` with ``serve_dtype`` float32): the prior and the denoiser
    run as their ``compute_view`` in ``compute_dtype`` on their float32
    weights, in eval mode, with the two ``Decoder`` modules; the chain, its
    draws and the ISTFT run in float32.  K1 and K2 run; K3 does not (JAX
    runs the flax modules here, ``_resolve_fused`` -> ``""``).  Not
    ``Enhancer(dtype=torch.bfloat16)``, the bf16 *serving* path (cast
    weights, packed encoder on K3-bf16, the dual decoder)."""

    def __init__(self, dis, ddpm, cfg: ExperimentConfig = ExperimentConfig(),
                 device="cuda", sigma: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(dis, ddpm, cfg, device, sigma)
        self.compute_dtype = compute_dtype
        self.views = (compute_view(self.dis, compute_dtype),
                      compute_view(self.ddpm, compute_dtype))

    def packs(self):
        raise TypeError("a bf16-compute enhancer runs the modules; it packs nothing")

    @torch.no_grad()
    def prior(self, feat: torch.Tensor) -> torch.Tensor:
        """The prior's eval-mode bf16-compute forward of ``feat`` (float32);
        its output in the prior's own dtype (bf16, or float32 where the
        model casts back, as GRN and some DB-AIAT variants do)."""
        return self.views[0].eval()(feat)

    @torch.no_grad()
    def chain(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None,
              x_T: Optional[torch.Tensor] = None, prior_dtype_x_init: bool = False):
        """As :meth:`Enhancer.chain` with the nets in ``compute_dtype`` and
        the chain in float32: JAX's ``enhance_batch`` (``x_init`` the prior's
        output cast to float32, then divided by ``c``) or, with
        ``prior_dtype_x_init``, its ``_eval_step`` (``x_init`` divided by
        ``c`` in the prior's dtype, its sigma mask in that dtype too)."""
        diff = self.cfg.diffusion
        dis, ddpm = (v.eval() for v in self.views)
        with span("enh.prior"):
            out = dis(feat)
        x_init = (out if prior_dtype_x_init else out.float()) / diff.scale_c
        sig = sigma_mask(x_init) if self.sigma else None
        cond = self.conditioner(feat, diff.scale_c, x_init)

        noise, x_T = self._draws(tuple(x_init.shape), generator, x_T)

        def model_fn(x, t):
            return (ddpm(x, t) if cond is None else ddpm(x, cond, t)).float()

        audio = reverse_sample(
            model_fn, x_init, x_T, self.sched, sig_mask=sig, noise=noise,
            zero_init=diff.zero_init, predict=diff.predict, mode=self.mode,
            dtype=torch.float32)
        return audio * diff.scale_c, x_init

    def eval_chain(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None,
                   x_T: Optional[torch.Tensor] = None):
        """The trainer's evaluation: :meth:`chain` as JAX's ``_eval_step``."""
        return self.chain(feat, generator, x_T, prior_dtype_x_init=True)
