"""The plain reference holds to the program's own plain composition (its
kernels off, float32) at a tiny size on the CPU.  This is the only place
the two meet: the benchmark's reference imports nothing of the program."""
import numpy as np
import pytest
import torch

from benchlib import support, weights
from benchlib.noise import KeyedNoise
from conftest import tiny
from reference import model as ref_model
from reference import train as ref_train


@pytest.fixture(scope="module")
def setup():
    cell = tiny("vg.sample")
    mc = cell.model_config
    cfg = support.program_config(mc)
    w = weights.make(support.param_shapes(cfg), 7, "cpu")
    model = support.build_model(cfg, w, "cpu").eval()
    return cell, mc, cfg, w, model


def _batch(n, b=3, seed=0):
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy(np.arange(n)[None] < rng.integers(2, n + 1, size=b)[:, None])
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(b, n, n, generator=g)
    x = torch.randn(b, n, 5, generator=g)
    return ref_model.mask_adjs(a, flags), ref_model.mask_nodes(x, flags), flags


def test_denoiser_matches_the_programs_plain_composition(setup):
    from diffusesg_torch.models.precond import precond_forward
    cell, mc, cfg, w, model = setup
    shape = ref_model.Shape.of(mc)
    a, x, flags = _batch(shape.n)
    sig = torch.tensor([0.01, 1.0, 30.0])
    sc_a, sc_x = 0.5 * a, 0.5 * x
    with torch.no_grad():
        want = precond_forward(model, "edm", a, x, flags, sig, sc_a, sc_x)
        got = ref_model.denoise(w, shape, a, x, flags, sig, sc_a, sc_x)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)


def test_loss_and_gradient_match_the_programs_step(setup):
    from diffusesg_torch.train import make_loss_fn, train_step_config_from
    cell, mc, cfg, w, model = setup
    shape = ref_model.Shape.of(mc)
    a, x, flags = _batch(shape.n, b=4, seed=3)
    a = torch.where(flags[:, :, None] & flags[:, None, :], a.clamp(-1, 1), 0.0)
    x = ref_model.mask_nodes(x.clamp(-1, 1), flags)
    noise = KeyedNoise(11, "cpu")
    for step in (0, 1):  # one coin of each kind
        loss_fn = make_loss_fn(model.train(), train_step_config_from(cfg))
        model.zero_grad()
        loss, _ = loss_fn(None, noise, step, a, x, flags)
        loss.backward()
        draws = {"sigma": noise.normal(step, "sigma", (4,)),
                 "noise_adj": noise.normal(step, "noise_adj", a.shape),
                 "noise_node": noise.normal(step, "noise_node", x.shape)}
        ref_loss, g, _ = ref_train.grads(w, shape, [(a, x, flags, draws, noise.bernoulli(
            step, "self_cond", 0.5))], block=3)
        assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
        for n, p in model.named_parameters():
            torch.testing.assert_close(g[n], p.grad, rtol=1e-4, atol=1e-7)


def test_control_quantizes_to_float8():
    t = torch.linspace(-3, 3, 101)
    q = ref_model.fp8_quant(t)
    assert 0 < float((q - t).abs().max()) <= 3 / 448 * 32
    assert torch.equal(ref_model.fp8_quant(q), q)
