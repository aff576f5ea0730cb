"""The port's multi-process bring-up (``stepth_tpu_torch/parallel/
distributed.py``) against the JAX package's (``stepth_tpu/parallel/
distributed.py``) in one process, and the mesh's slot ownership.

In one process both packages answer alike: ``initialize`` does nothing,
``process_info()`` is ``(0, 1)``, and ``global_mesh`` is the process's own
devices with the reference's shape errors. The two-process paths are in
``tests/test_torch_multiprocess.py``.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stepth_tpu.parallel import distributed as ref_distributed
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.parallel import distributed, mesh, sharded

from tests.torch_port import np_, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_single_process_is_a_no_op(monkeypatch):
    """One process: nothing to join, as in the reference; the count comes
    from ``STEPTH_NUM_PROCESSES`` when not given."""
    monkeypatch.delenv("STEPTH_NUM_PROCESSES", raising=False)
    assert ref_distributed.initialize() is None
    assert distributed.initialize() is None
    monkeypatch.setenv("STEPTH_NUM_PROCESSES", "1")
    distributed.initialize(coordinator_address="localhost:1", process_id=0)
    assert not torch.distributed.is_initialized()
    # two processes named by the environment: it tries to join them, and
    # without a process id or a rendezvous it raises instead of running alone
    monkeypatch.setenv("STEPTH_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(process_id=1)
    assert not torch.distributed.is_initialized()


def test_process_info_single_process():
    assert distributed.process_info() == ref_distributed.process_info() == (0, 1)
    assert distributed.is_coordinator() and ref_distributed.is_coordinator()
    distributed.barrier()  # one process: nothing to wait for


def test_failed_rendezvous_raises():
    """A process whose coordinator never answers raises within its startup
    timeout; it never carries on as one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        distributed.initialize(f"localhost:{port}", num_processes=2, process_id=1,
                               initialization_timeout_s=1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("data, tile", [(1, None), (2, None), (2, 4), (4, 2), (8, 1)])
def test_global_mesh_single_process_matches_reference(data, tile):
    want = ref_distributed.global_mesh(data=data, tile=tile)
    got = distributed.global_mesh(data=data, tile=tile, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got == mesh.make_mesh(data=data, tile=tile, devices=["cpu"] * 8)
    assert not got.spans_processes and got.first == torch.device("cpu")


@pytest.mark.parametrize("data, tile", [(3, None), (3, 3), (1, 9), (2, 5)])
def test_global_mesh_errors_match_reference(data, tile):
    with pytest.raises(ValueError) as want:
        ref_distributed.global_mesh(data=data, tile=tile)
    with pytest.raises(ValueError) as got:
        distributed.global_mesh(data=data, tile=tile, devices=["cpu"] * len(jax.devices()))
    assert str(got.value) == str(want.value)


def test_global_mesh_without_devices_takes_the_cuda_devices():
    if torch.cuda.is_available():
        assert distributed.global_mesh().shape["tile"] == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.global_mesh()


def test_single_process_mesh_is_all_local():
    m = mesh.make_mesh(data=2, tile=3, devices=["cpu"] * 6)
    assert m.ranks == ((0, 0, 0), (0, 0, 0)) and m.this_rank == 0
    assert all(m.is_local((d, t)) for d in range(2) for t in range(3))
    assert not m.spans_processes and all(m.row(1).is_local(i) for i in range(3))
    assert m.first == torch.device("cpu")


def test_mesh_of_two_processes_from_rank_one():
    """Rank 1's view of a 1×4 mesh over two processes: its first slot is
    slot 2, ``scatter_rows`` reads only its rows, and a block list of
    another process's slots holds None."""
    m = mesh.Mesh(((torch.device("cpu"),) * 4,), ((0, 0, 1, 1),), this_rank=1)
    assert m.spans_processes and not m.is_local((0, 1)) and m.is_local((0, 2))
    assert m.first == torch.device("cpu")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    x[:4] = np.nan  # rank 0's rows: never read
    blocks = sharded.scatter_rows(x, m.row(0))
    assert blocks[0] is None and blocks[1] is None
    np.testing.assert_array_equal(np_(torch.cat(blocks[2:])), x[4:])
    with pytest.raises(ValueError, match="owns no slot"):
        _ = mesh.Mesh(((torch.device("cpu"),),), ((0,),), this_rank=1).first


def test_single_process_halo_and_gather_unchanged(rng):
    """With every slot local the row-aware halo exchange and gather equal
    the device-list forms bit for bit."""
    x = rng.uniform(-100, 100, (24, 10)).astype(np.float32)
    m = mesh.make_mesh(tile=4, devices=["cpu"] * 4)
    by_row = sharded.scatter_rows(x, m.row(0))
    by_devs = sharded.scatter_rows(x, m.devices[0])
    for (t1, b1), (t2, b2) in zip(sharded.halo_exchange_rows(by_row, 3, "replicate", m.row(0)),
                                  sharded.halo_exchange_rows(by_devs, 3, "replicate")):
        assert torch.equal(t1, t2) and torch.equal(b1, b2)
    np.testing.assert_array_equal(np_(sharded._gather(m, m.row(0), by_row)), x)
    cfg = MatchConfig(num_disparities=8, window=5)
    left = np.round(rng.uniform(0, 255, (32, 48))).astype(np.float32)
    right = np.roll(left, -3, axis=1)
    a = sharded.match_pair_sharded(left, right, cfg, m)
    b = sharded.match_pair_sharded(left, right, cfg, mesh.make_mesh(tile=4,
                                                                    devices=["cpu"] * 4))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_nccl_refuses_two_ranks_on_one_card():
    """Under NCCL two ranks naming the same card (by UUID) raise, naming
    both ranks; so does a rank with two cards or none."""
    same = [(["cuda:0"], ["GPU-a"]), (["cuda:0"], ["GPU-b"]), (["cuda:1"], ["GPU-a"])]
    with pytest.raises(ValueError, match="ranks 0 and 2 name the same card GPU-a"):
        distributed._check_one_card_each(same)
    with pytest.raises(ValueError, match="rank 1 must hold exactly one CUDA card"):
        distributed._check_one_card_each([(["cuda:0"], ["GPU-a"]), (["cpu"], [])])
    distributed._check_one_card_each([(["cuda:0"], ["GPU-a"]), (["cuda:0"], ["GPU-b"])])


_RANK0_HOSTS = """
import sys
from stepth_tpu_torch.parallel import distributed
rank, port = int(sys.argv[1]), int(sys.argv[2])
distributed.initialize(f"localhost:{port}", 2, rank, heartbeat_timeout_s=30,
                       initialization_timeout_s=30)
m = distributed.global_mesh(data=2, tile=3, devices=["cpu"] * 3)
assert distributed.process_info() == (rank, 2) and m.this_rank == rank
print("ranks", m.ranks, "max", distributed.max_over_ranks(10.0 * rank), flush=True)
"""


def test_initialize_rank_zero_serves_the_rendezvous(tmp_path):
    """Without a store, rank 0 serves the ``TCPStore`` at the coordinator
    address and rank 1 joins it; the global mesh is laid out process-major.
    A port taken between choosing and binding it is retried."""
    script = tmp_path / "join.py"
    script.write_text(_RANK0_HOSTS)
    env = dict(os.environ, PYTHONPATH=REPO)
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=60)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        if all(p.returncode == 0 for p in procs) or "EADDRINUSE" not in outs[0]:
            break
    assert [p.returncode for p in procs] == [0, 0], outs
    for out in outs:
        assert "ranks ((0, 0, 0), (1, 1, 1)) max 10.0" in out, out


def test_drill_runs_on_the_card_unless_asked_for_the_cpu():
    """The drill's entry point takes ``cuda:0`` by default and raises when
    no card is visible; the CPU is asked for by name."""
    from stepth_tpu_torch.parallel import drill

    args, modes = drill.parse_args(["0", "1", "0", "match"])
    assert args.device == "cuda" and modes == ["match"]
    assert drill.parse_args(["0", "1", "0", "match", "--device", "cpu"])[0].device == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.run(args, modes)


def test_ordered_gather_refuses_parts_unlike_the_stated_layout():
    """A caller that states the parts' shape and dtype (no header
    collective) is held to it before anything is sent."""
    with pytest.raises(ValueError, match="one shape and dtype"):
        distributed.all_gather_ordered([torch.zeros(2)], [0], "cpu",
                                       like=((3,), torch.float32))
    with pytest.raises(ValueError, match="one shape and dtype"):
        distributed.all_gather_ordered([torch.zeros(2), torch.zeros(3)], [0, 0], "cpu")
    with pytest.raises(ValueError, match="owns 2 slots, got 1 parts"):
        distributed.all_gather_ordered([torch.zeros(2)], [0, 0], "cpu")
