#!/usr/bin/env python3
"""CPU probes of the GCRN and DB-AIAT priors against the JAX package
(development tools; the port and ``chip_smoke.py`` do not use them).  They
import both packages, so they run where JAX runs, on the CPU:

    python3 tools/prior_probe.py tel
    python3 tools/prior_probe.py layernorm
    python3 tools/prior_probe.py step
    python3 tools/prior_probe.py ddpm

``tel`` differentiates one DB-AIAT ``TransformerEncoderLayer`` (d = 32,
``[22, 80, 32]``, weights, input and output cotangent from seeds) in JAX
(float32) and in the port (float32 and float64), and prints each
parameter's gradient and the input's gradient against the float64 one,
relative L2; then the JAX bidirectional GRU alone the same way.

``layernorm`` normalises rows of 1024 N(0, 1) values shifted by 0, 3 and
30 with flax's ``nn.LayerNorm`` (one-pass variance), a one-pass formula
in torch and torch's ``nn.LayerNorm`` (two-pass), each against the
float64 result.

``step`` takes one ``ComplexTrainer`` step (``com_mag_mse_loss``, batch 2 x
1600, the JAX initial state carried across) for GCRN and
``aia_complex_trans_ri`` in both packages and prints what
``tests/test_torch_complex_trainer.py`` bounds: the loss, the largest
group-norm difference, the gradient, the same-sign steady updates and the
Adam moments, relative.

``ddpm`` takes one ``ComplexDDPMTrainer`` joint ``--sigma`` step with a
GCRN prior on JAX's q-sample draws in both packages, then the port's step
again on the clean batch times ``1 + 1e-7 N(0, 1)`` (two draws): how far
rounding alone moves the port's own DDPM group norms, gradient and
updates, beside the port-vs-JAX distances.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

rel = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def tel() -> None:
    import flax.linen as nn
    import torch.nn.functional as F

    from prior_diffuse_tpu.models import dbaiat as jdb
    from prior_diffuse_tpu.models import layers as jl
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict
    from prior_diffuse_tpu_torch.models import dbaiat, layers
    from test_torch_priors import perturb

    def f64_forward(self, src):  # the layer without its float32 cast of the GRU input
        src = self.norm1(src + self.self_attn(self.norm3(src)))
        return self.norm2(src + self.linear2(F.relu(self.gru(src))))

    x = np.random.default_rng(1).standard_normal((22, 80, 32)).astype(np.float32)
    for label, jm, tm in (("TransformerEncoderLayer", jdb.TransformerEncoderLayer(32),
                           dbaiat.TransformerEncoderLayer(32)),
                          ("bidirectional GRU alone", jl.GRU(64, bidirectional=True),
                           layers.GRU(32, 64, True))):
        v = perturb(nn.Module.init(jm, jax.random.PRNGKey(0), jnp.asarray(x)),
                    np.random.default_rng(0))
        tm.load_state_dict(flax_to_state_dict(tm, v))
        y, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), v["params"],
                         jnp.asarray(x))
        ct = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
        gp, gx = vjp(jnp.asarray(ct))
        jax_grads = flax_to_state_dict(tm, {"params": jax.tree.map(np.asarray, gp)})
        grads = {}
        for dtype in (torch.float32, torch.float64):
            m = copy.deepcopy(tm).to(dtype)
            if dtype == torch.float64 and isinstance(m, dbaiat.TransformerEncoderLayer):
                m.forward = f64_forward.__get__(m)
            xt = torch.from_numpy(x).to(dtype).requires_grad_()
            m(xt).backward(torch.from_numpy(ct).to(dtype))
            grads[dtype] = ({n: p.grad.double().numpy() for n, p in m.named_parameters()},
                            xt.grad.double().numpy())
        (g32, x32), (g64, x64) = grads[torch.float32], grads[torch.float64]
        print(f"{label}: input gradient vs float64: JAX {rel(gx, x64):.2e}, "
              f"port {rel(x32, x64):.2e}")
        for n in g32:
            print(f"  {n}: JAX {rel(jax_grads[n].double().numpy(), g64[n]):.2e}, "
                  f"port {rel(g32[n], g64[n]):.2e}")


def layernorm() -> None:
    from prior_diffuse_tpu.models import layers as jl

    for off in (0.0, 3.0, 30.0):
        x = (np.random.default_rng(2).standard_normal((2, 12, 1024)) + off).astype(np.float32)
        x64 = x.astype(np.float64)
        mean = x64.mean(-1, keepdims=True)
        exact = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(-1, keepdims=True) + 1e-5)
        v = jl.LayerNorm().init(jax.random.PRNGKey(0), jnp.asarray(x))
        flax_out = np.asarray(jl.LayerNorm().apply(v, jnp.asarray(x)))
        xt = torch.from_numpy(x)
        m = xt.mean(-1, keepdim=True)
        one_pass = ((xt - m) * torch.rsqrt(torch.clamp((xt * xt).mean(-1, keepdim=True) - m * m,
                                                       min=0.0) + 1e-5)).numpy()
        with torch.no_grad():
            two_pass = torch.nn.LayerNorm(1024)(xt).numpy()
        err = lambda a: np.abs(a - exact).max() / np.abs(exact).max()
        print(f"rows of mean {off:g}, std 1, against float64: flax {err(flax_out):.2e}, "
              f"one-pass torch {err(one_pass):.2e}, torch nn.LayerNorm {err(two_pass):.2e}; "
              f"nn.LayerNorm against flax {np.abs(two_pass - flax_out).max() / np.abs(flax_out).max():.2e}")


def _corpus(root):
    from prior_diffuse_tpu.data import synthetic

    return synthetic.write_corpus_speechlike(root, n_train=4, n_test=2, min_len=2000,
                                             max_len=3000, seed=6)


def step() -> None:
    import prior_diffuse_tpu.config as jcfg
    import test_torch_complex_trainer as T
    from prior_diffuse_tpu.parallel.mesh import make_mesh
    from prior_diffuse_tpu.training import ComplexTrainer as JTrainer
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from test_torch_train_step import _adam, _flat, _jax_grad, _np, _rel_l2, _steady

    with tempfile.TemporaryDirectory() as root:
        corpus = _corpus(os.path.join(root, "corpus"))
        for name in T.LR:
            jtr = JTrainer(jcfg.RunConfig(assets=os.path.join(root, "j"), doc="t",
                                          data_root=corpus), T._exp(jcfg, name),
                           mesh=make_mesh(dp=1))
            state0, batch = _np(jtr.state["model"]), T._batch(corpus)
            jstate, loss, gn = jtr._train_step(
                jtr.state, *jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums))
            tr = T._trainer(name, corpus, os.path.join(root, "p"))
            tr.model.load_state_dict(flax_to_state_dict(tr.model, state0))
            got_loss, got_gn = tr._train_step(*T._torch_batch(batch))
            want = {k: float(v) for k, v in gn.items()}
            top = max(want.values())
            gn_rel = max(abs(float(got_gn[k]) - v) / v for k, v in want.items()
                         if v > 1e-6 * top)
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in tr.model.named_parameters()}
            g_want = _jax_grad(jstate["opt"])
            g_got = _flat(state_dict_to_flax(tr.model, grads)["params"])
            steady = _steady(jstate["opt"]) & (np.sign(g_got) == np.sign(g_want))
            old = _flat(state0["params"])
            d_want = _flat(_np(jstate["model"]["params"])) - old
            d_got = _flat(state_dict_to_flax(tr.model, tr.model.state_dict())["params"]) - old
            names = [n for n, _ in tr.model.named_parameters()]
            st = tr.opt.state_dict()["state"]
            moments = []
            for key, jt in (("exp_avg", _adam(jstate["opt"]).mu),
                            ("exp_avg_sq", _adam(jstate["opt"]).nu)):
                got = _flat(state_dict_to_flax(tr.model, {
                    n: st[i][key] if i in st else torch.zeros_like(grads[n])
                    for i, n in enumerate(names)})["params"])
                moments.append(_rel_l2(got[steady], _flat(_np(jt))[steady]))
            print(f"{name}: loss {abs(float(got_loss) - float(loss)) / float(loss):.2e}, "
                  f"group norms up to {gn_rel:.2e}, gradient {_rel_l2(g_got, g_want):.2e}, "
                  f"steady updates {_rel_l2(d_got[steady], d_want[steady]):.2e}, moments "
                  f"{moments[0]:.2e} / {moments[1]:.2e} (relative)")


def ddpm() -> None:
    import prior_diffuse_tpu.config as jcfg
    import test_torch_complex_trainer as T
    import test_torch_prior_ddpm as P
    from prior_diffuse_tpu.parallel.mesh import make_mesh
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer
    from prior_diffuse_tpu_torch import config as tcfg
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
    from test_torch_train_step import _flat, _jax_draws, _jax_grad, _np, _rel_l2, _steady

    with tempfile.TemporaryDirectory() as root:
        corpus = _corpus(os.path.join(root, "corpus"))
        flags = dict(doc="t", data_root=corpus, joint=True, sigma=True)
        jtr = JTrainer(jcfg.RunConfig(assets=os.path.join(root, "j"), **flags), P._exp(jcfg),
                       mesh=make_mesh(dp=1))
        state0 = {k: _np(jtr.state[k]) for k in ("dis", "ddpm")}
        batch, key = T._batch(corpus), jax.random.PRNGKey(11)
        jstate, *_, gn = jtr._train_step(
            jtr.state, *jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums), key)
        draws = _jax_draws(key, jtr.exp.diffusion, (2, T.CHUNK // 160 + 1, 161, 2))
        want = {k: float(v) for k, v in gn.items()}

        def port(scale=0.0, seed=0):
            tr = ComplexDDPMTrainer(tcfg.RunConfig(assets=os.path.join(root, "p"), **flags),
                                    P._exp(tcfg), device="cpu")
            for n in ("dis", "ddpm"):
                tr.nets[n].load_state_dict(flax_to_state_dict(tr.nets[n], state0[n]))
            noisy, clean, frames = T._torch_batch(batch)
            if scale:
                g = torch.Generator().manual_seed(seed)
                clean = clean * (1 + scale * torch.randn(clean.shape, generator=g))
            gnorms = {k: float(v) for k, v in
                      tr._train_step(noisy, clean, frames, draws=draws)[3].items()}
            dist = {}
            for n in ("dis", "ddpm"):
                net, old = tr.nets[n], _flat(state0[n]["params"])
                g_got = _flat(state_dict_to_flax(
                    net, {k: p.grad for k, p in net.named_parameters()})["params"])
                g_want = _jax_grad(jstate["opt_" + n])
                steady = _steady(jstate["opt_" + n]) & (np.sign(g_got) == np.sign(g_want))
                d_got = _flat(state_dict_to_flax(net, net.state_dict())["params"]) - old
                d_want = _flat(_np(jstate[n]["params"])) - old
                dist[n] = (_rel_l2(g_got, g_want), _rel_l2(d_got[steady], d_want[steady]))
            return gnorms, dist

        g0, d0 = port()
        worst = sorted(((abs(g0[k] - v) / v, k) for k, v in want.items()), reverse=True)[:3]
        print("port vs JAX: group norms " + ", ".join(f"{k} {r:.2e}" for r, k in worst)
              + "; " + "; ".join(f"{n} gradient {a:.2e}, steady updates {b:.2e}"
                                 for n, (a, b) in d0.items()))
        for seed in (1, 2):
            g1, d1 = port(1e-7, seed)
            worst = sorted(((abs(g1[k] - g0[k]) / g0[k], k) for k in g0), reverse=True)[:3]
            print(f"clean x (1 + 1e-7 N(0, 1)), draw {seed}: the port's own group norms move "
                  + ", ".join(f"{k} {r:.2e}" for r, k in worst) + "; against JAX: "
                  + "; ".join(f"{n} gradient {a:.2e}, steady updates {b:.2e}"
                              for n, (a, b) in d1.items()))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("probe", choices=["tel", "layernorm", "step", "ddpm"])
    torch.set_num_threads(4)
    {"tel": tel, "layernorm": layernorm, "step": step, "ddpm": ddpm}[p.parse_args().probe]()


if __name__ == "__main__":
    main()
