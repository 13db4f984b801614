"""How the port's processes find their place (vqa_tpu_torch/parallel/mesh.py
and the dry run's entry point), in this one process.

- the launch variables: the JAX entry point's and torchrun's, with and
  without torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``;
- ``host_place``: without those, the ranks that share this rank's host are
  counted by host name at the rendezvous (two hosts of two ranks each);
- the backend rule: ``nccl`` only where each rank of a host has a card;
- a world of one process creates no process group, and its mesh is None;
- the dry run runs on the card unless given ``--device cpu``.
"""

import pytest
import torch
import torch.distributed as dist

from vqa_tpu_torch.parallel import dryrun
from vqa_tpu_torch.parallel import mesh as mesh_lib

LAUNCH_VARS = ("VQA_TPU_MULTIHOST", "VQA_TPU_COORD", "VQA_TPU_NPROCS",
               "VQA_TPU_PROC_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_launch_env_reads_both_launchers(clean_env):
    assert mesh_lib._launch_env() is None
    clean_env.setenv("VQA_TPU_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="VQA_TPU_COORD"):
        mesh_lib._launch_env()
    clean_env.setenv("VQA_TPU_COORD", "node0:1234")
    clean_env.setenv("VQA_TPU_NPROCS", "8")
    clean_env.setenv("VQA_TPU_PROC_ID", "5")
    # no local counts: host_place counts them at the rendezvous
    assert mesh_lib._launch_env() == {
        "url": "tcp://node0:1234", "rank": 5, "world": 8,
        "local_rank": None, "local_world": None}
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh_lib._launch_env() == {
        "url": "tcp://node0:1234", "rank": 5, "world": 8,
        "local_rank": 1, "local_world": 4}
    for name in LAUNCH_VARS[:4]:
        clean_env.delenv(name)
    clean_env.setenv("RANK", "6")
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("MASTER_ADDR", "node0")
    assert mesh_lib._launch_env() == {
        "url": "env://", "rank": 6, "world": 8, "local_rank": 1,
        "local_world": 4}


@pytest.mark.parametrize("rank,host,want", [(0, "a", (0, 2)), (1, "a", (1, 2)),
                                            (2, "b", (0, 2)), (3, "b", (1, 2))])
def test_host_place_counts_the_ranks_of_a_host(rank, host, want):
    """Two hosts of two ranks: each rank's local rank and local world are
    those of its host, not of the world of four."""
    store = dist.HashStore()
    posted = dist.PrefixStore("vqa_tpu_hosts", store)
    for r, h in enumerate("aabb"):
        if r != rank:
            posted.set(str(r), h)
    assert mesh_lib.host_place(store, rank, 4, host) == want


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    # two hosts of four ranks, a card each: NCCL
    assert mesh_lib.backend_for("cuda", 8, 4)[0] == "nccl"
    # more ranks on a host than it has cards: gloo
    assert mesh_lib.backend_for("cuda", 8, 8)[0] == "gloo"
    assert mesh_lib.backend_for("cpu", 8, 4)[0] == "gloo"


def test_a_world_of_one_has_no_process_group(clean_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        mesh_lib.init_distributed("cuda")
    world = mesh_lib.init_distributed("cpu")
    assert (world.rank, world.world, world.backend, world.created) == \
        (0, 1, None, False)
    assert world.device == torch.device("cpu")
    assert not dist.is_initialized()
    assert mesh_lib.make_mesh() is None and mesh_lib.make_mesh(1, 1) is None
    with pytest.raises(ValueError, match="degenerate mesh 0x2 on 1"):
        mesh_lib.make_mesh(n_model=2)
    assert mesh_lib.is_main()
    assert mesh_lib.all_gather_object(3) == [3]
    assert mesh_lib.broadcast_object(4) == 4


def test_dryrun_runs_on_the_card_unless_told_cpu(clean_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--procs", "2"])
