"""The frozen reference against the port on the CPU at a tiny size, and the
frozen count against the port's own roofline count.  (The reference itself
imports nothing of the port: ``test_bench_imports.py``.)"""

import numpy as np
import pytest
import torch

from benchmark.count.flops import flops_of
from benchmark.count.stages import stage_shapes, stage_work
from benchmark.harness.inputs import seeded_state
from benchmark.reference import dsp, models as ref, train as rtrain
from prior_diffuse_tpu_torch.models import complex_prior_class
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1
from prior_diffuse_tpu_torch.signal.compress import compress_spec, decompress_spec
from prior_diffuse_tpu_torch.signal.stft import istft_plain, stft_plain
from prior_diffuse_tpu_torch.utils import roofline

CPU = torch.device("cpu")
NETS = [("DiffUNet", lambda: ref.DiffUNet(), lambda: complex_prior_class("DiffUNet")()),
        ("DiffUNet1", lambda: ref.DiffUNet1(50), lambda: DiffUNet1(50)),
        ("aia_complex_trans_ri", lambda: ref.AiaComplexTransRI(),
         lambda: complex_prior_class("aia_complex_trans_ri")())]


def pair(make_ref, make_port, seed=11):
    state = seeded_state(make_ref(), seed, CPU, 1)
    r, p = make_ref(), make_port()
    r.load_state_dict(state)
    p.load_state_dict(state)
    return r.eval(), p.eval()


def args_of(name, x):
    return (x,) if name != "DiffUNet1" else (x, x, torch.tensor([2.5, 31.0]))


@pytest.mark.parametrize("name,make_ref,make_port", NETS, ids=[n[0] for n in NETS])
def test_nets_agree_with_the_port(name, make_ref, make_port):
    r, p = pair(make_ref, make_port)
    x = torch.randn(2, 21, 161, 2, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, got = r(*args_of(name, x)), p(*args_of(name, x))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_signal_path_agrees_with_the_port():
    x = torch.randn(3, 4801, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    spec = dsp.stft(x)
    assert torch.allclose(spec, stft_plain(x), atol=1e-10)
    assert torch.allclose(dsp.compress(spec), compress_spec(spec, "sqrt"), atol=1e-10)
    assert torch.allclose(dsp.decompress(spec), decompress_spec(spec, "sqrt"), atol=1e-10)
    assert torch.allclose(dsp.istft(spec, 4801), istft_plain(spec, length=4801), atol=1e-10)
    assert torch.allclose(dsp.istft(spec, 4801), x, atol=1e-9)


def test_schedule_agrees_with_the_port():
    from prior_diffuse_tpu_torch.config import DiffusionConfig
    from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule

    cfg = DiffusionConfig()
    port = inference_schedule(cfg)
    mine = dsp.schedule(cfg.noise_schedule, cfg.inference_noise_schedule)
    assert np.allclose(mine.t, port.T) and np.allclose(mine.c1, port.c1)
    assert np.allclose(mine.c2, port.c2) and np.allclose(mine.sigma, port.new_sigma)


@pytest.mark.parametrize("name,make_ref,make_port", NETS, ids=[n[0] for n in NETS])
def test_count_equals_the_port_roofline(name, make_ref, make_port):
    """The frozen count on the meta device equals ``utils/roofline.analyze``'s
    model FLOPs of the port's module forward on the CPU."""
    r, p = pair(make_ref, make_port)
    x = torch.randn(2, 13, 161, 2)
    with torch.no_grad():
        port = roofline.analyze(p, *args_of(name, x)).totals(roofline.CHIP_SPECS["H100 80GB HBM3"])
    meta = r.to("meta")
    xm = torch.empty(2, 13, 161, 2, device="meta")
    with torch.no_grad():
        mine = flops_of(meta, *args_of(name, xm)) if name != "DiffUNet1" else flops_of(
            meta, xm, xm, torch.empty(2, device="meta"))
    assert mine == port["model_flops"]


def test_train_count_equals_the_port_roofline():
    r, p = pair(ref.DiffUNet, lambda: complex_prior_class("DiffUNet")())
    r.train(), p.train()
    x = torch.randn(2, 13, 161, 2)

    def fwd_bwd(net, inp):
        net(inp).sum().backward()

    port = roofline.analyze(fwd_bwd, p, x).totals(roofline.CHIP_SPECS["H100 80GB HBM3"])
    assert flops_of(fwd_bwd, r.to("meta"), torch.empty(2, 13, 161, 2, device="meta")) \
        == port["model_flops"]


def test_stage_work_matches_the_count():
    """The encoder-stage arithmetic equals the count of the reference's
    stages (``conv1`` included) at a small shape."""
    enc = ref.Encoder(time_cond=False).to("meta").eval()
    rows, frames = 2, 9
    x = torch.empty(rows, 2, frames, 161, device="meta")
    for i, (cin, freq, kf) in enumerate(stage_shapes(), start=1):
        with torch.no_grad():
            counted = flops_of(enc.stage, i, x)
            x = enc.stage(i, x)
        assert stage_work(rows, frames, cin, freq, kf, True, 4)[0] == counted


def test_train_step_agrees_with_the_port():
    """Three steps of the reference against ``ComplexDDPMTrainer`` through
    the benchmark's train driver, and the step after a window of one step
    followed from the program's state, at 2 x 4800 on the CPU: losses to
    1e-5, the median leaf's gradient to 1e-3 and change to 1e-2."""
    from benchmark.harness import core
    from conftest import SEED, SMALL

    cell = core.load_cell("diffunet.train-f32", SMALL["diffunet.train-f32"])
    d = core.load_driver("train")(core.Context(cell, SEED, CPU))
    d.setup()
    d.window(0.0, None)
    d.after_window()
    d.release()
    got = {r.name: r.value for r in d.check()}
    assert {"late_loss_gap", "late_grad_gap", "late_change_gap"} <= set(got)
    for pre in ("", "late_"):
        assert got[pre + "loss_gap"] < 1e-5 and got[pre + "grad_gap"] < 1e-3
        assert got[pre + "change_gap"] < 1e-2


def test_reference_adam_is_torch_adam():
    p1 = torch.nn.Parameter(torch.randn(5, generator=torch.Generator().manual_seed(1)))
    p2 = torch.nn.Parameter(p1.detach().clone())
    mine, theirs = rtrain.Adam([p1], 1e-3, 1e-7), torch.optim.Adam([p2], 1e-3, weight_decay=1e-7)
    for k in range(3):
        g = torch.randn(5, generator=torch.Generator().manual_seed(10 + k))
        p1.grad, p2.grad = g.clone(), g.clone()
        mine.step()
        theirs.step()
    assert torch.allclose(p1, p2, atol=1e-7)
    # and from torch's moments after those steps, one step more
    st = theirs.state[p2]
    later = rtrain.Adam([p1], 1e-3, 1e-7)
    later.m, later.v, later.t = [st["exp_avg"].clone()], [st["exp_avg_sq"].clone()], 3
    g = torch.randn(5, generator=torch.Generator().manual_seed(20))
    p1.grad, p2.grad = g.clone(), g.clone()
    later.step()
    theirs.step()
    assert torch.allclose(p1, p2, atol=1e-7)
