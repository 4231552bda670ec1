"""The port's multihost.initialize() contract (torch.distributed mocked),
the counterpart of tests/test_multihost.py for the JAX package:

- the group is made from the environment and the arguments alone: no
  query of a group (world size, rank) comes before init_process_group;
- explicit coordinator arguments are forwarded (a host:port becomes a
  tcp:// address), with the timeout, on the gloo backend for the CPU;
- torchrun's environment triggers init from the environment;
- no cluster signal -> no init call at all (one process);
- already initialised -> idempotent no-op;
- init failures PROPAGATE;
- a single-node SLURM job does not init, a multi-node one does (its
  SLURM_* variables become torchrun's, and it must name its coordinator);
- host_shard_range splits over nodes: even for train, ceil for eval.
"""
import datetime

import pytest
import torch.distributed as dist

from dgod_tpu_torch.parallel import multihost

CLUSTER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "SLURM_JOB_NUM_NODES",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID")


class _Recorder:
    def __init__(self):
        self.calls = []
        self.already = False
        self.fail = False

    def is_initialized(self):
        self.calls.append("is_initialized")
        return self.already

    def init_process_group(self, backend, **kw):
        self.calls.append(("init", backend, kw))
        if self.fail:
            raise RuntimeError("coordinator unreachable")

    # canaries: a group query before init_process_group
    def get_world_size(self, *a, **k):
        self.calls.append("get_world_size")
        return 1

    def get_rank(self, *a, **k):
        self.calls.append("get_rank")
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    for name in ("is_initialized", "init_process_group", "get_world_size",
                 "get_rank"):
        monkeypatch.setattr(dist, name, getattr(rec, name))
    for v in CLUSTER_VARS:  # absent, and restored to absent afterwards
        monkeypatch.setenv(v, "0")
        monkeypatch.delenv(v)
    return rec


def _init(rec):
    return [c for c in rec.calls if c[0] == "init"]


def test_explicit_coordinator_forwards_args(recorder):
    timeout = datetime.timedelta(seconds=30)
    multihost.initialize(coordinator_address="10.0.0.1:8476",
                         num_processes=4, process_id=2, device="cpu",
                         timeout=timeout)
    assert recorder.calls == [
        "is_initialized",
        ("init", "gloo", dict(init_method="tcp://10.0.0.1:8476",
                              timeout=timeout, world_size=4, rank=2)),
    ], "no group query may precede init_process_group()"


def test_torchrun_env_triggers_init_from_env(recorder, monkeypatch):
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "h"),
                 ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    multihost.initialize(device="cpu")
    (call,) = _init(recorder)
    assert call[1] == "gloo" and call[2]["init_method"] == "env://"
    assert "world_size" not in call[2]
    assert "get_world_size" not in recorder.calls
    assert "get_rank" not in recorder.calls


def test_single_host_no_init(recorder):
    multihost.initialize(device="cpu")
    assert recorder.calls == ["is_initialized"]


def test_idempotent_when_already_initialized(recorder):
    recorder.already = True
    multihost.initialize(coordinator_address="10.0.0.1:8476", device="cpu")
    assert recorder.calls == ["is_initialized"]


def test_failures_propagate(recorder):
    recorder.fail = True
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        multihost.initialize(coordinator_address="10.0.0.1:8476",
                             device="cpu")


def test_num_processes_without_address_still_initializes(recorder):
    """Explicit num_processes/process_id (coordinator from MASTER_ADDR)
    must not silently no-op on the one-process gate."""
    multihost.initialize(num_processes=4, process_id=2, device="cpu")
    (call,) = _init(recorder)
    assert call[2]["init_method"] == "env://"
    assert (call[2]["world_size"], call[2]["rank"]) == (4, 2)


def test_single_node_slurm_does_not_auto_init(recorder, monkeypatch):
    """SLURM sets SLURM_JOB_NUM_NODES=1 on every job, single-node
    interactive shells included: that alone is no cluster."""
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    multihost.initialize(device="cpu")
    assert recorder.calls == ["is_initialized"]


def test_multi_node_slurm_auto_inits(recorder, monkeypatch):
    for k, v in (("SLURM_JOB_NUM_NODES", "2"), ("SLURM_PROCID", "5"),
                 ("SLURM_NTASKS", "8"), ("SLURM_LOCALID", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")
    assert _init(recorder) == []
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    multihost.initialize(device="cpu")
    (call,) = _init(recorder)
    assert call[2]["init_method"] == "env://"
    import os
    assert [os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                    "LOCAL_WORLD_SIZE")] == ["5", "8", "1",
                                                             "4"]


def test_host_shard_range_even_vs_ceil(monkeypatch):
    """even=True must give every node the same floor(n/k) slice (unequal
    per-node TRAIN batch counts leave ranks waiting in a collective); the
    default ceil split covers every example (eval)."""
    monkeypatch.setattr(multihost, "node_count", lambda: 3)
    ranges_ceil, ranges_even = [], []
    for p in range(3):
        monkeypatch.setattr(multihost, "node_index", lambda p=p: p)
        ranges_ceil.append(multihost.host_shard_range(10))
        ranges_even.append(multihost.host_shard_range(10, even=True))
    assert ranges_ceil == [(0, 4), (4, 8), (8, 10)]
    assert ranges_even == [(0, 3), (3, 6), (6, 9)]
    assert {b - a for a, b in ranges_even} == {3}
