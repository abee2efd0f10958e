"""Port of tests/test_multihost.py: two CPU processes, each set up by
`parallel.multihost.init` from RANK / WORLD_SIZE in its environment (a file
store as the rendezvous, so concurrent test workers cannot collide on a
port), join one gloo world; a global-mesh psum, a DTensor assembled from
each process's rows (`host_local_to_global`), the sharded voxel-plane match
with the map split over "mp" ACROSS the two processes, and one sharded Loc
step. The rank program (tests/test_torch_dist_workers.py:multihost_main) imports
no jax. Unlike the JAX package's test this one is not marked slow.

Stated tolerances: the psum and the assembled sum exact; the match within
0.15 m of the true motion (test_multihost.py's bound); both processes
return the same pose bits; the Loc step finite.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loc_lib_tpu_torch.parallel import multihost

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def test_two_process_world_from_the_environment(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS])
    code = ("import sys, test_torch_dist_workers as w; "
            "w.multihost_main(sys.argv[1], sys.argv[2])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, f"file://{tmp_path / 'store'}", str(tmp_path / f"out{r}")],
        env=dict(env, RANK=str(r), WORLD_SIZE="2"), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    res = [pickle.loads((tmp_path / f"out{r}").read_bytes()) for r in range(2)]
    assert [r["rank"] for r in res] == [0, 1] and [r["mp_index"] for r in res] == [0, 1]
    for r in res:
        assert r["global_shape"] == (4, 1) and r["global_sum"] == 6.0
        assert r["psum"] == 3.0
        assert np.isfinite(r["t"]).all()
        assert np.linalg.norm(r["t"] - r["t_rel"]) < 0.15, (r["t"], r["t_rel"])
        assert not r["overflow"].any()
        assert np.isfinite(r["loc_t"]).all()
    np.testing.assert_array_equal(res[0]["t"], res[1]["t"])
    np.testing.assert_array_equal(res[0]["loc_t"], res[1]["loc_t"])


def test_init_without_a_world_is_a_no_op(monkeypatch):
    """No init_method, no MASTER_ADDR and no world size: a single-process
    run, nothing set up."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init() is False
    assert not multihost.is_multiprocess()


def test_init_refuses_several_ranks_without_a_rendezvous(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="init_method"):
        multihost.init()


def test_launch_reports_a_failing_rank():
    """A rank that raises ends the launch with its error output; the other
    ranks are stopped."""
    with pytest.raises(RuntimeError, match="of 2 failed") as err:
        multihost.launch("test_torch_dist_workers:failing_rank", 2, device="cpu",
                         extra_paths=[TESTS], timeout=120)
    assert "this rank fails on purpose" in str(err.value)


def test_init_and_launch_default_to_the_card(monkeypatch, tmp_path):
    """A rank computes on the card unless it asks for the CPU: without a
    card, init with a world configured and launch raise instead of
    setting up a gloo world on the host; with one, init takes it and
    NCCL."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    store = f"file://{tmp_path / 'store'}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.init(store, 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.launch("test_torch_dist_workers:failing_rank", 2, extra_paths=[TESTS])
        assert not dist.is_initialized()
        return
    assert multihost.init(store, 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        assert torch.cuda.current_device() == 0
    finally:
        dist.destroy_process_group()
