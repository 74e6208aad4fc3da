"""The eval slice on the CPU: the port's ``sg_go_sampling`` against the JAX
one (diffusesg_tpu/sampling/orchestrator.py) on shared weights and draws,
plain and with ``inpaint_frac``; in-training sampling through
``go_training``; ``cli.eval``, ``cli.eval_samples`` and
``select_checkpoints``.

Sampling runs the small model (vg_small_test cut to N = 16, 4 steps) on an
eval set of 8 synthetic graphs in two batches of 4.  The decoded integer
arrays must be equal; the continuous samples and the boxes agree at the
slice tests' 1e-3 / 1e-3 (fp32 on both sides, different op order).  The
metric block is held at 1e-9 where both sides see the same inputs: every
metric of the port's run that reads only the integer graphs, and every
metric of the port's ``evaluate_samples`` on the JAX run's own arrays.
The box metrics of the two runs read boxes that differ by up to 1e-3,
and are held at BOX_METRIC_ATOL.
"""
import csv
import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import JaxKeyNoise, load_pair, model_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = os.path.join(REPO, "configs", "vg_small_test.yaml")
RTOL = 1e-9
SAMPLE_ATOL, SAMPLE_RTOL = 1e-3, 1e-3
# BLT scores and F1 of boxes 1e-3 apart (the box-sample tolerance above)
BOX_METRIC_ATOL = 2e-3
INT_KEYS = ("samples_a", "samples_x", "samples_node_flags", "gt_a", "gt_x", "gt_node_flags",
            "gt_image_ids")
FLOAT_KEYS = ("samples_x_bbox", "gt_x_bbox", "raw_a", "raw_x", "interim_a", "interim_x")


def _no_plots(monkeypatch):
    """Both packages' plots off (they are not compared, and they take tens
    of seconds here); the port's plotting runs in the cli.eval test."""
    import diffusesg_tpu.eval.sg_statistics as jstat
    import diffusesg_tpu.utils.visual as jvis
    import diffusesg_torch.eval.sg_statistics as tstat
    import diffusesg_torch.utils.visual as tvis
    for mod in (jstat, tstat):
        monkeypatch.setattr(mod, "_plot_report", lambda *a, **k: None)
    for mod in (jvis, tvis):
        for name in ("plot_graphs_adj", "plot_scene_graph", "plot_scene_graph_bbox"):
            monkeypatch.setattr(mod, name, lambda *a, **k: None)


def _configs(tmp_path, tag):
    jcfg, tcfg = load_pair(num_steps=4, s_churn=40.0)
    for cfg, side in ((jcfg, "jax"), (tcfg, "port")):
        with cfg.unlocked():
            cfg.dataset.synthetic_num_train = 8
            cfg.dataset.synthetic_num_test = 12
            cfg.test.eval_size = 8
            cfg.test.batch_size = 4
            cfg.tpu.num_devices = 1  # the JAX run on one device, batch 4 as the port's
            cfg.logdir = str(tmp_path / f"{side}_{tag}")
        os.makedirs(cfg.logdir)
    return jcfg, tcfg


def _box_metric(key: str) -> bool:
    return "blt" in key or "f1" in key


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("inpaint_frac", [None, 0.5])
def test_sg_go_sampling_matches_jax(tmp_path, monkeypatch, inpaint_frac):
    import pandas as pd
    from diffusesg_tpu.data import load_data as jload
    from diffusesg_tpu.sampling import get_mc_sampler as jget
    from diffusesg_tpu.sampling.orchestrator import sg_go_sampling as jsample
    from diffusesg_torch.data import load_data
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.orchestrator import (append_results_csv, evaluate_samples,
                                                       sg_go_sampling)
    _no_plots(monkeypatch)
    jcfg, tcfg = _configs(tmp_path, "inpaint" if inpaint_frac else "plain")
    jm, params, tm = model_pair(jcfg, tcfg)
    jb, tb = jload(jcfg, data_root="/nonexistent"), load_data(tcfg, data_root="/nonexistent")
    sp = {"model_nm": "m", "weight_kw": "1.000", "model_path": "p"}
    j_metrics = jsample(jm, params, jget(jcfg), jcfg, jb, eval_mode=True, sampling_params=sp,
                        inpaint_frac=inpaint_frac)

    # the JAX run's per-batch keys: rng = PRNGKey(seed + epoch); rng, sub = split(rng)
    sampler = get_mc_sampler(tcfg)
    rng, subs = jax.random.PRNGKey(int(tcfg.seed)), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        subs.append(sub)
    noises = [JaxKeyNoise(k, sampler.num_steps, inpaint=inpaint_frac is not None) for k in subs]
    t_metrics = sg_go_sampling(tm, None, sampler, tcfg, tb, eval_mode=True, sampling_params=sp,
                               inpaint_frac=inpaint_frac, noise_factory=lambda bi: noises[bi])
    assert all(n.requests for n in noises)

    # decoded arrays (npz artifacts of both runs)
    def npz(cfg):
        (path,) = glob.glob(os.path.join(cfg.logdir, "sampling_during_evaluation", "*",
                                         "final_samples_array.npz"))
        return dict(np.load(path))
    j_res, t_res = npz(jcfg), npz(tcfg)
    assert sorted(t_res) == sorted(j_res)
    for k in INT_KEYS:
        np.testing.assert_array_equal(t_res[k], j_res[k], err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(t_res[k], j_res[k], atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL,
                                   err_msg=k)
    assert t_res["interim_a"].shape[:2] == (8, 5)  # 4 + 4 kept, slots 0..4
    if inpaint_frac is not None:
        # the known nodes' types and boxes, and the edges among them, are the
        # ground truth's decode
        flags = t_res["gt_node_flags"]
        known = (np.arange(flags.shape[1])[None] < np.ceil(flags.sum(1) * 0.5)[:, None]) & flags
        pair = known[:, :, None] & known[:, None, :]
        np.testing.assert_array_equal(t_res["samples_x"][known], t_res["gt_x"][known])
        np.testing.assert_array_equal(t_res["samples_a"][pair], t_res["gt_a"][pair])
        np.testing.assert_allclose(t_res["samples_x_bbox"][known], t_res["gt_x_bbox"][known],
                                   rtol=0, atol=1e-7)
        assert not np.array_equal(t_res["samples_x"][flags & ~known],
                                  t_res["gt_x"][flags & ~known])

    # the metric dicts of the two runs
    seconds = t_metrics.pop("_seconds")
    assert set(seconds) == {"sampling_decode", "metrics_artifacts"}
    assert sorted(t_metrics) == sorted(j_metrics)
    for k, want in j_metrics.items():
        if k == "_mat_f1":
            for name in want:
                np.testing.assert_allclose(t_metrics[k][name], want[name], rtol=0,
                                           atol=BOX_METRIC_ATOL, err_msg=name)
            continue
        tol = dict(rtol=0, atol=BOX_METRIC_ATOL) if _box_metric(k) else dict(rtol=RTOL, atol=0)
        np.testing.assert_allclose(t_metrics[k], want, err_msg=k, **tol)

    # the port's metric block on the JAX run's own arrays: 1e-9 everywhere
    res = {"q_adj": j_res["samples_a"], "q_adj_gt": j_res["gt_a"],
           "q_node": j_res["samples_x"], "q_node_gt": j_res["gt_x"],
           "flags": j_res["samples_node_flags"], "flags_gt": j_res["gt_node_flags"],
           "bbox": j_res["samples_x_bbox"], "bbox_gt": j_res["gt_x_bbox"]}
    same = evaluate_samples(res, tcfg, tb, 150, 51, False, False, True, False)
    assert sorted(same) == sorted(j_metrics)
    for k, want in j_metrics.items():
        if k == "_mat_f1":
            for name in want:
                np.testing.assert_allclose(same[k][name], want[name], rtol=RTOL, atol=0)
        else:
            np.testing.assert_allclose(same[k], want, rtol=RTOL, atol=0, err_msg=k)

    # eval_results.csv: the JAX one (pandas) and the port's (csv) parse alike
    j_csv = pd.read_csv(os.path.join(jcfg.logdir, "eval_results.csv"))
    t_csv = pd.read_csv(os.path.join(tcfg.logdir, "eval_results.csv"))
    assert list(t_csv.columns) == list(j_csv.columns) and len(t_csv) == len(j_csv) == 1
    for col in j_csv.columns:
        if not pd.api.types.is_numeric_dtype(j_csv[col]):
            assert t_csv[col].tolist() == j_csv[col].tolist(), col
        else:
            tol = (dict(rtol=0, atol=BOX_METRIC_ATOL) if _box_metric(col)
                   else dict(rtol=RTOL, atol=0))
            np.testing.assert_allclose(t_csv[col], j_csv[col], err_msg=col, **tol)
    # and the port's writer on the JAX run's row writes pandas' text
    row = dict(sp, **{k: v for k, v in j_metrics.items() if not k.startswith("_")})
    append_results_csv(str(tmp_path / "again.csv"), row)
    with open(os.path.join(jcfg.logdir, "eval_results.csv")) as f, \
            open(tmp_path / "again.csv") as g:
        assert g.read() == f.read()


EXPECTED_KEYS = (
    ["gen_data_size", "test_data_size", "node_degree_mmd_gaussian", "node_average_mmd_gaussian",
     "node_type_mmd_gaussian", "edge_type_mmd_gaussian"]
    + [f"triplet_{m}_{t}" for t in ("val", "train")
       for m in ("tv_dist_rej", "tv_dist_all", "tv_dist_full", "novelty")]
    + [f"{p}_{m}_blt" for p in ("pred", "gt") for m in ("iou", "iou_percp", "overlap", "alignment")]
    + [f"{w}_f1_avg_{s}" for w in ("vanilla", "area", "freq", "no_node_type")
       for s in ("max", "mean", "median")])
MMD_KEYS = ("node_degree_mmd_gaussian", "node_average_mmd_gaussian", "node_type_mmd_gaussian",
            "edge_type_mmd_gaussian")


def test_go_training_samples_without_touching_the_training_state(tmp_path, monkeypatch):
    """In-training sampling with the largest-beta EMA at epochs 0 and 1:
    epoch 0 is the ground-truth sanity check (every MMD 0.0), and the
    model's parameters, Adam's state and the training noise stream are
    bit-equal before and after each sampling pass."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, go_training, make_optimizer,
                                       train_step_config_from)
    from diffusesg_torch.train import trainer
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger
    _no_plots(monkeypatch)
    cfg = load_config(SMALL_CFG, overrides={
        "subset": 8, "train.batch_size": 4, "test.batch_size": 4, "save_interval": 1,
        "sample_interval": 1, "eval_size": 4, "num_steps": 2, "max_epoch": 2,
        "exp_dir": str(tmp_path)})
    set_seed_and_logger(cfg, mode="train", log_level="WARNING")
    bundle = load_data(cfg, data_root="/nonexistent")
    model = build_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, list(cfg.train.ema_coef),
                               make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 2))
    noise = TorchNoise(3, "cpu")

    def snapshot():
        opt = [t.clone() for s in state.opt.state.values() for t in s.values()]
        return ([p.detach().clone() for p in state.params()], opt, noise.gen.get_state(),
                noise.host_gen.get_state(), state.step)

    real, calls = trainer.sg_go_sampling, []

    def watched(model_, params, *args, **kw):
        assert model_ is model and not any(p is q for p in params.values()
                                           for q in state.params())
        assert all(p is e for p, e in zip(params.values(), state.ema_params[-1]))
        before = snapshot()
        out = real(model_, params, *args, **kw)
        after = snapshot()
        same = (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
                and len(before[1]) == len(after[1]) > 0
                and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
                and torch.equal(before[2], after[2]) and torch.equal(before[3], after[3])
                and before[4] == after[4])
        calls.append((kw["epoch"], kw["sanity_check"], kw["sampling_params"]["weight_kw"], same))
        return out
    monkeypatch.setattr(trainer, "sg_go_sampling", watched)
    state = go_training(model, state, train_step_config_from(cfg), cfg, bundle,
                        mc_sampler=get_mc_sampler(cfg), noise=noise)
    assert state.step == 4
    assert calls == [(0, True, "0.999", True), (1, False, "0.999", True)]
    rows = _read_csv(os.path.join(cfg.logdir, "eval_results.csv"))
    assert [r["model_nm"] for r in rows] == ["training_e00000", "training_e00001"]
    assert all(float(rows[0][k]) == 0.0 for k in MMD_KEYS)
    assert list(rows[0]) == ["model_nm", "weight_kw", "model_path"] + EXPECTED_KEYS
    for sub in ("epoch_00000_sanity_check", "epoch_00001_model_inference"):
        assert os.path.exists(os.path.join(cfg.logdir, "sampling_during_training",
                                           f"eval_{sub}", "final_samples_array.npz"))


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A port run directory as ``cli.train`` leaves it: config.yaml and
    checkpoints of epochs 0 and 1 (the seeded model, its EMAs moved apart)."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import save_checkpoint
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger
    cfg = load_config(SMALL_CFG, overrides={"exp_dir": str(tmp_path_factory.mktemp("train"))})
    set_seed_and_logger(cfg, mode="train", log_level="WARNING")
    state = create_train_state(build_model(cfg, device="cpu", seed=0), list(cfg.train.ema_coef),
                               make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1))
    for epoch in (0, 1):
        with torch.no_grad():
            for ema in state.ema_params:
                torch._foreach_add_(ema, 0.01 * (epoch + 1))
        save_checkpoint(os.path.join(cfg.model_ckpt_dir, f"{epoch:05d}"), state,
                        {"epoch": epoch})
    return cfg.logdir


def test_cli_eval_and_eval_samples_on_the_cpu(trained_run, tmp_path, monkeypatch):
    from diffusesg_torch.cli import eval as eval_cli
    from diffusesg_torch.cli import eval_samples
    base = ["-p", trained_run, "--device", "cpu", "--eval_size", "8", "--num_steps", "2",
            "--data_root", "/nonexistent", "--use_ema", "0.999", "--specify_epoch", "1",
            "-o", f"exp_dir={tmp_path}"]
    with pytest.MonkeyPatch.context() as mp:  # the lighter plots only
        import diffusesg_torch.eval.sg_statistics as tstat
        import diffusesg_torch.utils.visual as tvis
        mp.setattr(tstat, "_plot_report", lambda *a, **k: None)
        mp.setattr(tvis, "plot_scene_graph_bbox", lambda *a, **k: None)
        plain = eval_cli.main(base + ["-m", "plain"])
    with pytest.MonkeyPatch.context() as mp:
        _no_plots(mp)
        inpaint = eval_cli.main(base + ["-m", "inpaint", "--inpaint_frac", "0.5"])
    for (metrics,) in (plain, inpaint):
        keys = [k for k in metrics if not k.startswith("_")]
        assert keys == EXPECTED_KEYS
        assert all(np.isfinite(metrics[k]) for k in keys)
    runs = {r.rsplit("_", 1)[1]: r
            for r in glob.glob(os.path.join(str(tmp_path), "vg_small_test", "*"))}
    assert sorted(runs) == ["inpaint", "plain"]
    for tag, suffix in (("plain", ""), ("inpaint", "_inpaint0.5")):
        rows = _read_csv(os.path.join(runs[tag], "eval_results.csv"))
        assert [r["model_nm"] for r in rows] == [f"00001.pt{suffix}"]
        assert rows[0]["weight_kw"] == "0.9990"
        (out,) = glob.glob(os.path.join(runs[tag], "sampling_during_evaluation", "*"))
        for name in ("final_samples_array.npz", "gen_scene_graph.txt", "sg_statistics.txt"):
            assert os.path.exists(os.path.join(out, name)), name
        # matplotlib is here: the plain run's plots are written
        assert bool(glob.glob(os.path.join(out, "*.png"))) == (tag == "plain")

    # re-score the plain run's samples offline: the same metrics
    (npz,) = glob.glob(os.path.join(runs["plain"], "sampling_during_evaluation", "*",
                                    "final_samples_array.npz"))
    _no_plots(monkeypatch)
    again = eval_samples.main(["--npz", npz, "-c", os.path.join(runs["plain"], "config.yaml"),
                               "--data_root", "/nonexistent", "--device", "cpu"])
    for k in EXPECTED_KEYS:
        np.testing.assert_allclose(again[k], plain[0][k], rtol=RTOL, atol=0, err_msg=k)
    assert os.path.exists(os.path.join(os.path.dirname(npz), "eval_sg_helper_plots",
                                       "eval_metrics.txt"))


@pytest.mark.parametrize("flag", ["--sanity_check", "--random_node_num", "--skip_eval"])
def test_cli_eval_options(trained_run, tmp_path, monkeypatch, flag):
    """The sanity check scores the ground truth against itself (every MMD
    0.0); --random_node_num samples node counts drawn from the test set's;
    --skip_eval writes the samples and no metric."""
    from diffusesg_torch.cli import eval as eval_cli
    _no_plots(monkeypatch)
    (metrics,) = eval_cli.main(["-p", trained_run, "--device", "cpu", "--eval_size", "8",
                                "--num_steps", "2", "--data_root", "/nonexistent",
                                "--use_ema", "none", "--specify_epoch", "0",
                                "-o", f"exp_dir={tmp_path}", flag])
    (run,) = glob.glob(os.path.join(str(tmp_path), "vg_small_test", "*"))
    (out,) = glob.glob(os.path.join(run, "sampling_during_evaluation", "*"))
    res = np.load(os.path.join(out, "final_samples_array_before_eval.npz"))
    if flag == "--skip_eval":
        assert list(metrics) == ["_seconds"]
        assert not os.path.exists(os.path.join(run, "eval_results.csv"))
        return
    assert [k for k in metrics if not k.startswith("_")] == EXPECTED_KEYS
    if flag == "--sanity_check":
        assert out.endswith("_sanity_check") and all(metrics[k] == 0.0 for k in MMD_KEYS)
        np.testing.assert_array_equal(res["samples_a"], res["gt_a"])
    else:
        from diffusesg_torch.config import load_config
        from diffusesg_torch.data import load_data
        test = load_data(load_config(os.path.join(run, "config.yaml")), eval_mode=True,
                         data_root="/nonexistent").test
        pool = {len(g["node_labels"]) for g in test.pkl_data}
        counts = res["samples_node_flags"].sum(1)
        assert set(counts.tolist()) <= pool and not np.array_equal(
            res["samples_node_flags"], res["gt_node_flags"])


def test_eval_entry_points_need_the_card_unless_asked(trained_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from diffusesg_torch.cli import eval as eval_cli
    from diffusesg_torch.cli import eval_samples
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_cli.main(["-p", trained_run, "--data_root", "/nonexistent",
                       "-o", f"exp_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_samples.main(["--npz", "none.npz", "-c", SMALL_CFG])


def test_select_checkpoints_matches_jax(tmp_path):
    """The same epochs from the JAX package's directory checkpoints and the
    port's files, for every selection option."""
    from diffusesg_tpu.utils.checkpoint import select_checkpoints as jselect
    from diffusesg_torch.utils.checkpoint import select_checkpoints
    names = ["00000", "00002", "00003", "00007", "00010", "00011", "00030", "preempt"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for name in names:
        os.makedirs(jdir / name)
        os.makedirs(tdir, exist_ok=True)
        (tdir / f"{name}.pt").write_bytes(b"")
    for kw in [{}, {"min_epoch": 3}, {"max_epoch": 10}, {"min_epoch": 2, "max_epoch": 11},
               {"specify_epoch": 7}, {"specify_epoch": [0, 30, 5]}, {"num_ckpts": 3},
               {"min_epoch": 1, "num_ckpts": 2}, {"num_ckpts": 20}]:
        want = [os.path.basename(p) for p in jselect(str(jdir), **kw)]
        got = [os.path.basename(p)[:-3] for p in select_checkpoints(str(tdir), **kw)]
        assert got == want, kw
