"""The slice end to end on the CPU: the port's sampling + decode entry point
vs the JAX serving core (``serving/export.py::_serving_impl``) on shared
weights and shared random draws; plus the port's import and device guards.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import JaxKeyNoise, load_pair, model_pair, node_flags  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = [16, 11, 5, 1]
SEED = 7
# continuous samples after 4 Heun steps (8 evals) at fp32: the per-eval
# atol 2e-4 bar compounds over the evals and the s_ratio/churn updates
SAMPLE_ATOL, SAMPLE_RTOL = 1e-3, 1e-3


def _jax_run(jcfg, jm, params, flags):
    from diffusesg_tpu.models.channels import resolve_sampling_channels
    from diffusesg_tpu.models.precond import precond_forward
    from diffusesg_tpu.sampling import get_mc_sampler
    from diffusesg_tpu.serving.export import _serving_impl

    sampler = get_mc_sampler(jcfg)
    info = resolve_sampling_channels(jcfg)
    impl = _serving_impl(jm, sampler, jcfg)

    def both(p, rng, f):
        def denoiser(a, x, sigmas, sc_a, sc_x):
            return precond_forward(lambda *args: jm.apply(p, *args), "edm", a, x, f, sigmas,
                                   sc_a, sc_x)
        cont = sampler.sample(denoiser, rng, f, info["num_node_chan"], info["num_adj_chan"])
        return impl(p, rng, f), cont

    dec, cont = jax.jit(both)(params, jax.random.PRNGKey(SEED), flags)
    return [np.asarray(d) for d in dec], [np.asarray(c) for c in cont]


@pytest.mark.parametrize("s_churn,refresh_p", [(0.0, 0.0), (40.0, 0.0), (40.0, 0.5)])
def test_generate_matches_jax_serving(s_churn, refresh_p):
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.generate import generate, make_denoiser

    jcfg, tcfg = load_pair(num_steps=4, s_churn=s_churn)
    for cfg in (jcfg, tcfg):
        with cfg.unlocked():
            cfg.mcmc.precond_self_cond_refresh_p = refresh_p
    jm, params, tm = model_pair(jcfg, tcfg)
    n = tcfg.dataset.max_node_num
    flags = node_flags(len(COUNTS), n, COUNTS)
    (j_adj, j_node, j_bbox), (j_cont_a, j_cont_x) = _jax_run(jcfg, jm, params, flags)

    sampler = get_mc_sampler(tcfg)
    refresh = refresh_p > 0
    noise = JaxKeyNoise(SEED, sampler.num_steps, refresh)
    t_adj, t_node, t_bbox = generate(tm, sampler, tcfg, COUNTS, device="cpu", noise=noise)
    kinds = {k for _, k in noise.requests}
    expect = {"init_adj", "init_node"}
    if s_churn:
        expect |= {"churn_adj", "churn_node"}
    if refresh:
        expect |= {"refresh_euler", "refresh_heun"}
    assert kinds == expect

    tflags = torch.from_numpy(flags)
    with torch.no_grad():
        cont_a, cont_x = sampler.sample(make_denoiser(tm, tcfg, tflags), tflags, 5, 1,
                                        noise=JaxKeyNoise(SEED, sampler.num_steps, refresh))
    np.testing.assert_allclose(cont_a.numpy(), j_cont_a, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)
    np.testing.assert_allclose(cont_x.numpy(), j_cont_x, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)

    np.testing.assert_array_equal(t_adj.numpy(), j_adj)
    np.testing.assert_array_equal(t_node.numpy(), j_node)
    np.testing.assert_allclose(t_bbox.numpy(), j_bbox, atol=SAMPLE_ATOL)
    assert int(t_node[3, 1:].abs().sum()) == 0 and int(t_adj[3].abs().sum()) == 0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusesg_torch\n"
        "for m in pkgutil.walk_packages(diffusesg_torch.__path__, 'diffusesg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'diffusesg_tpu'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "for name in ('serving.generate', 'cli.train', 'train.trainer', 'data.loader',\n"
        "             'utils.checkpoint', 'ops.box_ops', 'ops.window_attention',\n"
        "             'ops.swin_block_kernel', 'ops.swin_full_block', 'ops.mm_microbench',\n"
        "             'sampling.orchestrator', 'sampling.debug', 'cli.eval',\n"
        "             'cli.eval_samples', 'eval.sg_evaluator', 'eval.sg_statistics',\n"
        "             'eval.native', 'utils.native_build', 'utils.visual',\n"
        "             'serving.server', 'serving.export', 'cli.serve', 'cli.import_ckpt',\n"
        "             'utils.torch_import', 'utils.perf', 'parallel.distributed',\n"
        "             'parallel.mesh', 'parallel.shardmap_dp', 'parallel.sharded_step'):\n"
        "    assert 'diffusesg_torch.' + name in sys.modules, name\n"
        "# the card's machine has none of the plotting packages or pandas\n"
        "lazy = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('matplotlib', 'networkx', 'PIL', 'pandas'))\n"
        "assert not lazy, lazy\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('mb', 'scripts/microbench_int8_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'diffusesg_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_by(path):
    import ast
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    return imported


def test_chip_smoke_imports_no_jax():
    imported = _imported_by("chip_smoke.py")
    assert "diffusesg_torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "optax", "orbax", "diffusesg_tpu"}, imported


def test_serve_probe_imports_no_jax_and_needs_the_card():
    imported = _imported_by("serve_probe.py")
    assert "diffusesg_torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "optax", "orbax", "diffusesg_tpu"}, imported
    if torch.cuda.is_available():
        return
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "serve_probe.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr, out.stdout + out.stderr


def test_microbench_script_imports_torch_and_the_port_only():
    imported = _imported_by(os.path.join("scripts", "microbench_int8_torch.py"))
    assert imported == {"os", "subprocess", "sys", "torch", "diffusesg_torch"}, imported


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.generate import generate
    _, tcfg = load_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)
    model = build_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, get_mc_sampler(tcfg), tcfg, [3])
    # cli.serve's loader and load_artifact default to the card too
    from diffusesg_torch.cli.serve import _load_from_checkpoint, build_serve_parser
    from diffusesg_torch.serving.export import load_artifact
    with pytest.raises(RuntimeError, match="CUDA"):
        _load_from_checkpoint(build_serve_parser().parse_args(["-p", "no_such_run"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_artifact("no_such_artifact")


def test_coco_entry_points_and_the_microbench_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    import importlib.util

    from torch_parity import load_coco_pair
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.generate import generate
    _, tcfg = load_coco_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)
    model = build_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, get_mc_sampler(tcfg), tcfg, [3])
    adj, node, bbox = generate(model, get_mc_sampler(tcfg), tcfg, [3, 20], device="cpu")
    assert adj.shape == (2, 20, 20) and int(node.max()) < 171 and int(adj.max()) < 7
    spec = importlib.util.spec_from_file_location(
        "microbench_int8_torch", os.path.join(REPO, "scripts", "microbench_int8_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.main() == 2
