"""``parallel/launch.py::run_ranks`` on gloo ranks on the CPU: a rank's
exception fails the caller with that rank's traceback (its peer, waiting
in a collective, fails too and may be seen first), and a rank that
outlives the caller's time limit is killed and reported, so neither
hangs the caller.  Results in rank order are held by every multi-rank
test (tests/test_torch_halo_solve.py, tests/test_torch_sharded.py)."""

import time

import pytest

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.parallel.launch import RankError

import test_torch_dist_ranks as ranks


def test_run_ranks_results_errors_and_time_limit():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 failed on purpose"):
        gt.run_ranks(ranks.fail_or_wait, 2, "gloo", "cpu", ("raise",),
                     timeout_s=60)
    with pytest.raises(TimeoutError):
        gt.run_ranks(ranks.fail_or_wait, 2, "gloo", "cpu", ("sleep",),
                     timeout_s=4)
    assert time.monotonic() - t0 < 50
