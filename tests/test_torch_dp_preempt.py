"""A signal to one rank of a data-parallel ``cli.train`` stops every rank.

Two ranks of tests/helpers/torch_dp_child.py run ``cli.train`` on the tiny
config of tests/test_torch_dp_train.py for up to 200 epochs, under each
``tpu.spmd_mode``.  Once epoch
0's checkpoint is on disk, SIGTERM goes to rank 1 alone: both ranks finish
the epoch they are in and stop together, rank 0 writing ``preempt.pt``.
"""
import os
import signal
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from test_torch_dp_train import _args, _run_dirs  # noqa: E402
from torch_parity import start_ranks, wait_ranks  # noqa: E402


@pytest.fixture(scope="module", params=["shard_map", "gspmd"])
def runs(request, tmp_path_factory):
    long = str(tmp_path_factory.mktemp(f"dp_preempt_{request.param}") / "preempted")
    ranks = start_ranks(_args(long, 200, "--sample_interval", "1000",
                              "-o", f"tpu.spmd_mode={request.param}"),
                        os.path.join(long, "logs"))
    deadline, signalled = time.time() + 180, None
    while time.time() < deadline and signalled is None:
        if any(os.path.exists(os.path.join(d, "models_ckpt", "00000.pt"))
               for d in _run_dirs(long)):
            ranks[1][0].send_signal(signal.SIGTERM)
            signalled = time.time()
        elif any(p.poll() is not None for p, _ in ranks):
            break
        time.sleep(0.05)
    return long, wait_ranks(ranks), signalled


def test_a_signal_to_one_rank_stops_both_at_the_epoch_end(runs):
    """Rank 1 got SIGTERM; rank 0 learnt of it at the epoch's end, both left
    together, and rank 0 wrote ``preempt.pt`` for the epoch they finished."""
    long, _, signalled = runs
    assert signalled is not None
    run = _run_dirs(long)[0]
    ckpts = os.listdir(os.path.join(run, "models_ckpt"))
    assert "preempt.pt" in ckpts
    extra = torch.load(os.path.join(run, "models_ckpt", "preempt.pt"), weights_only=False)["extra"]
    last = max(int(c[:-3]) for c in ckpts if c[:-3].isdigit())
    assert extra == {"epoch": last + 1, "preempted": True}  # the epoch it finished
    assert extra["epoch"] < 199
    assert "preempted: saved models_ckpt/preempt.pt" in open(
        os.path.join(run, "process_0.log")).read()
    assert "signal 15" in open(os.path.join(run, "process_1.log")).read()
    assert "signal 15" not in open(os.path.join(run, "process_0.log")).read()
