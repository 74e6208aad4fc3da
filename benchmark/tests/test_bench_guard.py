"""The guard against the JAX stack and package, and the refusal to run
without a card."""
import os
import shutil
import subprocess
import sys
import types

from benchlib import support

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_forbidden_modules_compares_top_level_names_whole():
    planted = ["jax", "jax.numpy", "flax.linen", "diffusesg_tpu", "diffusesg_tpu.ops",
               "jaxtyping", "jaxlib"]
    saved = {m: sys.modules.get(m) for m in planted}
    try:
        for m in planted:
            sys.modules[m] = types.ModuleType(m)
        found = support.forbidden_modules()
        assert {"jax", "jax.numpy", "flax.linen", "diffusesg_tpu", "diffusesg_tpu.ops",
                "jaxlib"} <= set(found)
        assert "jaxtyping" not in found
        assert not any(m.startswith("diffusesg_torch") for m in found)
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def test_harness_and_program_load_no_jax():
    """What a run imports, the program's modules with it, loads no module
    of the JAX stack or package (in a fresh process)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchlib import cells, support\n"
        "for name in ('vg.sample', 'coco.sample', 'vg.train'):\n"
        "    cells.load(name).driver()\n"
        "import diffusesg_torch.serving.export, diffusesg_torch.sampling.factory\n"
        "import diffusesg_torch.train, diffusesg_torch.train.compiled\n"
        "import diffusesg_torch.parallel.shardmap_dp, diffusesg_torch.parallel.distributed\n"
        "import diffusesg_torch.data, diffusesg_torch.ops.cuda_build\n"
        "print(support.forbidden_modules())\n" % (HERE, ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vg.sample",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder does
    not run: the program is not there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
