"""The compiled sampler (``diffusesg_torch/sampling/compiled.py``) and the
compiled sampler's cache (``serving/export.py::save_compiled`` /
``load_compiled``) on the CPU.

* The runner's CPU path is the eager ``sample_steps``, bit for bit.
* The compiled data flow (a program's static buffers, its binding of a
  call's flags, operands and inpaint tensors, the row and draws copied in
  before each step, the eager first use of a variant, the replays) runs
  here with a stand-in for the CUDA calls whose "graph" replays by calling
  the captured body: bit-equal to the eager sampler over churn on and off,
  Heun and Euler, the self-conditioning refresh, inpainting, interim
  snapshots and ``chunk_steps``, and across calls of one runner.
* The restructured sampler through that flow against the JAX sampler on its
  own draws (``JaxKeyNoise``) at the fp32 parity bar of
  tests/test_reference_parity.py:124-125, on tiny VG and COCO-Stuff
  (window 10) models and on the toy denoiser with the corrected Heun step.
* The step variants of a schedule: exactly the expected set, and exactly
  the graphs a program captures.
* ``save_compiled`` / ``load_compiled``, as tests/test_serving.py:89-121
  holds the JAX pair: ``meta`` back, output bit-equal to the live function,
  FileNotFoundError, RuntimeError on more devices than the process has, a
  kernel library of other sources refused; asking for the card without
  one raises.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from graph_stand_in import _Stream, stand_in  # noqa: E402,F401 - the fixture
from torch_parity import (ATOL, RTOL, JaxKeyNoise, load_coco_pair, load_pair,  # noqa: E402
                          model_pair, node_flags)

from diffusesg_torch.ops import cuda_build  # noqa: E402
from diffusesg_torch.sampling.compiled import CompiledSampler  # noqa: E402
from diffusesg_torch.sampling.edm_sampler import (NodeAdjEDMSampler, StepVariant,  # noqa: E402
                                                  TorchNoise)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, SEED, STEPS = 3, 6, 11, 5
COUNTS = [6, 4, 1]
# the toy runs of tests/test_torch_sampler_inpaint.py
TOY_ATOL, TOY_RTOL, TOY_SIGMA_MAX = 1e-6, 1e-6, 2.0


def _toy(lib):
    """A denoiser that reads every input (tests/test_torch_sampler_inpaint.py)."""
    def fn(a, x, sigmas, sc_a, sc_x):
        sa = sigmas.reshape((-1,) + (1,) * (a.ndim - 1))
        sx = sigmas.reshape((-1,) + (1,) * (x.ndim - 1))
        return (lib.tanh(a + 0.1 * sc_a) * (1 + 0.01 * sa),
                lib.tanh(x - 0.2 * sc_x) * (1 - 0.01 * sx))
    return fn


def _toy_for(node_flags, *operands):
    return _toy(torch)


def _inpaint(rng, flags, a_shape, x_shape):
    known = (np.arange(N)[None, :] < np.ceil(flags.sum(1) / 2)[:, None]) & flags
    return {"gt_adjs": torch.from_numpy(rng.uniform(-1, 1, a_shape).astype(np.float32)),
            "mask_adjs": torch.from_numpy(known[:, :, None] & known[:, None, :]),
            "gt_nodes": torch.from_numpy(rng.uniform(-1, 1, x_shape).astype(np.float32)),
            "mask_nodes": torch.from_numpy(known)}


# (name, sampler fields, call options): churn on and off, Heun and Euler, the
# refresh, inpainting, interim snapshots, chunk_steps, symmetric noise, the
# corrected Heun step with alpha != 1
CASES = [
    ("heun-churn", dict(S_churn=40.0), {}),
    ("heun-no-churn", dict(S_churn=0.0), {}),
    ("euler-churn", dict(S_churn=40.0, solver="euler"), {}),
    ("refresh", dict(S_churn=40.0, self_condition=True, precond_self_cond_refresh_p=0.5), {}),
    ("inpaint", dict(S_churn=40.0, self_condition=True), dict(inpaint=True)),
    ("interim", dict(S_churn=40.0), dict(num_interim=3)),
    ("chunk", dict(S_churn=40.0, self_condition=True), dict(chunk_steps=2)),
    ("symmetric", dict(S_churn=40.0, symmetric_noise=True), dict(edge_chan=1)),
    ("corrected-heun", dict(S_churn=40.0, self_condition=True, heun_reuse_xhat=False,
                            alpha=0.5), {}),
]


def _call(case, seed=SEED, counts=COUNTS):
    """(sampler, arguments of ``sample`` but the denoiser, options)."""
    _, fields, opts = case
    sampler = NodeAdjEDMSampler(num_steps=STEPS, sigma_max=TOY_SIGMA_MAX, **fields)
    edge_chan, node_chan = opts.get("edge_chan", 2), 3
    flags = torch.from_numpy(node_flags(B, N, counts))
    kw = dict(num_interim=opts.get("num_interim", 0), chunk_steps=opts.get("chunk_steps"))
    if opts.get("inpaint"):
        kw["inpaint"] = _inpaint(np.random.default_rng(seed), flags.numpy(),
                                 (B, N, N, edge_chan), (B, N, node_chan))
    return sampler, (flags, node_chan, edge_chan), kw


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_runner_cpu_path_is_the_eager_sampler(case):
    sampler, args, kw = _call(case)
    want = sampler.sample(_toy(torch), *args, noise=TorchNoise(SEED, "cpu"), **kw)
    got = CompiledSampler(sampler).sample(_toy_for, *args, noise=TorchNoise(SEED, "cpu"), **kw)
    _equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compiled_steps_bit_equal_with_stand_in_graphs(case, stand_in):
    """Two calls of one runner (another seed and other flags in the second:
    the program's statics rebound, every variant replayed) against the eager
    sampler; the first use of each variant runs eagerly, later uses replay."""
    runner = None
    for seed, counts in ((SEED, COUNTS), (SEED + 1, [2, 6, 5])):
        sampler, args, kw = _call(case, seed, counts)
        runner = runner or CompiledSampler(sampler)
        want = sampler.sample(_toy(torch), *args, noise=TorchNoise(seed, "cpu"), **kw)
        got = runner.sample(_toy_for, *args, noise=TorchNoise(seed, "cpu"), **kw)
        _equal(got, want)
    (program,) = runner._programs.values()
    assert len(stand_in) == len(program.graphs) > 0 and not program.busy


def _variants(sampler, noise=None):
    noise = noise or TorchNoise(0, "cpu")
    return {sampler.step_variant(noise, i, row)
            for i, row in enumerate(sampler.step_coefficients())}


V = StepVariant
# (name, sampler fields, the variants of its 16-step schedule).  The EDM grid
# from 80 to 0.002 churns where 0.05 <= sigma <= 50: not step 0 (80), not
# the last steps; Heun's last step is Euler's.
VARIANT_CASES = [
    ("heun-churn", dict(S_churn=40.0, self_condition=True),
     {V(False, True, False, False), V(True, True, False, False), V(False, False, False, False)}),
    ("euler-no-churn", dict(S_churn=0.0, solver="euler"), {V(False, False, False, False)}),
    ("euler-churn", dict(S_churn=40.0, solver="euler"),
     {V(False, False, False, False), V(True, False, False, False)}),
    ("heun-churn-everywhere", dict(S_churn=40.0, S_min=0.0, S_max=1e9),
     {V(True, True, False, False), V(True, False, False, False)}),
    ("refresh-always", dict(S_churn=40.0, self_condition=True, precond_self_cond_refresh_p=1.0),
     {V(False, True, True, True), V(True, True, True, True), V(False, False, True, False)}),
    ("refresh-without-second-eval", dict(S_churn=0.0, self_condition=False,
                                         precond_self_cond_refresh_p=1.0),
     {V(False, True, False, False), V(False, False, False, False)}),
]


@pytest.mark.parametrize("name,fields,want", VARIANT_CASES, ids=[c[0] for c in VARIANT_CASES])
def test_step_variants_of_a_schedule(name, fields, want, stand_in):
    sampler = NodeAdjEDMSampler(num_steps=16, **fields)
    got = _variants(sampler)
    assert got == want and len(got) == len(want)
    flags = torch.from_numpy(node_flags(B, N, COUNTS))
    runner = CompiledSampler(sampler)
    runner.sample(_toy_for, flags, 3, 1, seed=0)
    (program,) = runner._programs.values()
    assert set(program.graphs) == want and len(stand_in) == len(want)


def _jax_sample(js, denoiser, key, flags, node_chan, edge_chan, **kw):
    import jax
    import jax.numpy as jnp
    return js.sample(denoiser, jax.random.PRNGKey(key), jnp.asarray(flags), node_chan,
                     edge_chan, **kw)


@pytest.mark.parametrize("which", ["vg", "coco"])
def test_compiled_small_model_matches_jax(which, stand_in):
    """The restructured sampler, compiled, on the JAX sampler's draws against
    the JAX sampler (jitted) on shared weights: 4 Heun steps with churn."""
    import jax

    from diffusesg_tpu.models.channels import resolve_sampling_channels
    from diffusesg_tpu.models.precond import precond_forward
    from diffusesg_tpu.sampling import get_mc_sampler as jget
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_denoiser

    jcfg, tcfg = (load_pair if which == "vg" else load_coco_pair)(num_steps=4, s_churn=40.0)
    jm, params, tm = model_pair(jcfg, tcfg)
    n = tcfg.dataset.max_node_num
    flags = node_flags(3, n, [n, n // 2, 3])
    info = resolve_sampling_channels(jcfg)
    js = jget(jcfg)

    def run(p, f):
        def denoiser(a, x, sigmas, sc_a, sc_x):
            return precond_forward(lambda *args: jm.apply(p, *args), "edm", a, x, f, sigmas,
                                   sc_a, sc_x)
        return _jax_sample(js, denoiser, SEED, f, info["num_node_chan"], info["num_adj_chan"])
    j_out = jax.jit(run)(params, flags)
    ts = get_mc_sampler(tcfg)
    t_out = CompiledSampler(ts).sample(
        lambda f: make_denoiser(tm, tcfg, f), torch.from_numpy(flags), info["num_node_chan"],
        info["num_adj_chan"], noise=JaxKeyNoise(SEED, ts.num_steps))
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_compiled_corrected_heun_matches_jax(stand_in):
    """The corrected Heun step (alpha 0.5, evaluated at (x', t')): the f32
    products in the JAX step's order, on the toy denoiser at its bar."""
    import jax.numpy as jnp

    from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as JSampler
    kw = dict(num_steps=STEPS, S_churn=40.0, self_condition=True, heun_reuse_xhat=False,
              alpha=0.5, sigma_max=TOY_SIGMA_MAX)
    flags = node_flags(B, N, COUNTS)
    j_out = _jax_sample(JSampler(**kw), _toy(jnp), SEED, flags, 3, 2)
    t_out = CompiledSampler(NodeAdjEDMSampler(**kw)).sample(
        _toy_for, torch.from_numpy(flags), 3, 2, noise=JaxKeyNoise(SEED, STEPS))
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOY_ATOL, rtol=TOY_RTOL)


def test_captured_launches_count_apart(stand_in):
    """A launch into the capture stream during a capture goes to the
    graph's record, not LAUNCHES."""
    import collections
    cuda_build.reset_launches()
    cuda_build.count_launch("k", "s")
    with cuda_build.capturing(collections.Counter(), _Stream()) as record:
        cuda_build.count_launch("k", "s")
        cuda_build.count_launch("k", "s")
    cuda_build.count_launch("k", "s")
    assert cuda_build.LAUNCHES == {("k", "s"): 2} and record == {("k", "s"): 2}
    cuda_build.reset_launches()


def test_install_adopts_a_library_of_these_sources_only(tmp_path, monkeypatch):
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"\x7fELF stand-in")
    monkeypatch.setattr(cuda_build, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="hash"):
        cuda_build.install(lib, "0" * 16)
    assert not (tmp_path / "build").exists()
    got = cuda_build.install(lib, cuda_build.source_hash())
    assert got == tmp_path / "build" / "libdsg_kernels.so" and got.read_bytes() == lib.read_bytes()


# --- save_compiled / load_compiled (tests/test_serving.py:89-121)

SERVE_B, SERVE_N = 4, 8


@pytest.fixture(scope="module")
def served():
    """(config, model, sampler): configs/vg_small_test.yaml at N 8, 4 steps,
    seeded weights, on the CPU."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    cfg = load_config(os.path.join(REPO, "configs", "vg_small_test.yaml"))
    with cfg.unlocked():
        cfg.dataset.max_node_num = SERVE_N
        cfg.mcmc.num_steps = 4
    return cfg, build_model(cfg, device="cpu", seed=0).eval(), get_mc_sampler(cfg)


def _save(served, path, num_devices=1):
    """``save_compiled`` of the served core at SERVE_B; returns the live
    function it was exported from."""
    from diffusesg_torch.serving.export import (export_sampler, fixed_batch, make_serving_fn,
                                                save_compiled)
    cfg, model, sampler = served
    save_compiled(str(path), export_sampler(model, sampler, cfg, SERVE_B, num_devices),
                  {"k": 1, "steps": 4})
    return fixed_batch(make_serving_fn(model, sampler, cfg), SERVE_B, SERVE_N, "cpu")


def test_compiled_serving_roundtrip(served, tmp_path):
    from diffusesg_torch.serving.export import load_compiled
    live = _save(served, tmp_path / "aot")
    loaded, meta = load_compiled(str(tmp_path / "aot"), device="cpu")
    assert meta == {"k": 1, "steps": 4}
    flags = node_flags(SERVE_B, SERVE_N, [8, 4, 1, 0])
    for got, want in zip(loaded(3, flags), live(3, flags)):
        np.testing.assert_array_equal(got, want)


def test_load_compiled_without_the_file_raises(tmp_path):
    from diffusesg_torch.serving.export import load_compiled
    with pytest.raises(FileNotFoundError):
        load_compiled(str(tmp_path / "nothing"), device="cpu")


def test_load_compiled_refuses_more_devices_than_the_process_has(served, tmp_path):
    from diffusesg_torch.serving.export import load_compiled
    _save(served, tmp_path / "two", num_devices=2)
    with pytest.raises(RuntimeError, match="spans 2 devices"):
        load_compiled(str(tmp_path / "two"), device="cpu")


def test_load_compiled_refuses_a_library_of_other_sources(served, tmp_path):
    import json

    from diffusesg_torch.serving.export import COMPILED_META, load_compiled
    _save(served, tmp_path / "aot")
    path = tmp_path / "aot" / COMPILED_META
    blob = json.loads(path.read_text())
    blob["kernels"] = {"source_hash": "0" * 16, "nvcc": "Build cuda_12.4", "arch": "sm_90a"}
    path.write_text(json.dumps(blob))
    with pytest.raises(RuntimeError, match="hash"):
        load_compiled(str(tmp_path / "aot"), device="cpu")


def test_compiled_entry_points_need_the_card_unless_asked(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from diffusesg_torch.serving import generate
    from diffusesg_torch.serving.export import load_compiled
    cfg, model, sampler = served
    _save(served, tmp_path / "aot")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_compiled(str(tmp_path / "aot"))
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, sampler, cfg, [3, 8])


@pytest.mark.parametrize("spmd_mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_sharded_serving_compiles_as_asked(served, stand_in, spmd_mode, compiled):
    """``make_sharded_serving_fn(compiled=...)`` builds each shard's core
    compiled or eager as asked (the stand-in graphs are captured only when
    compiled), and both give the eager sharded function's output."""
    from diffusesg_torch.serving.export import make_sharded_serving_fn
    cfg, model, sampler = served
    flags = node_flags(SERVE_B, SERVE_N, [8, 4, 1, 6])
    got = make_sharded_serving_fn(model, sampler, cfg, ["cpu", "cpu"], spmd_mode,
                                  compiled=compiled)(3, flags)
    assert bool(stand_in) == compiled
    stand_in.clear()
    want = make_sharded_serving_fn(model, sampler, cfg, ["cpu", "cpu"], spmd_mode,
                                   compiled=False)(3, flags)
    assert not stand_in
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
