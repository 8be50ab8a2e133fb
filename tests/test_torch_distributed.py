"""The parallel layer on the CPU: mesh, FSDP and multi-process training and
sampling over gloo (`parallel/{mesh,fsdp,multihost}.py`, `Trainer(mesh=...,
fsdp=...)`, `scripts.train --coordinator ... --fsdp`).

`spec_for_shape` against the JAX rule on a table of shapes; the row
selections and `make_mesh` in one process; then two spawned worker
processes (`_torch_dist_worker.py`, which block JAX and the JAX package
before importing anything, one torch thread each, each with its own
timeout; one spawn serves the file) on a gloo group:

  * a batch step, a streamed epoch (a full batch and a short one, split
    2 + 1) and a resident epoch, replicated and FSDP, against the port's
    one-process `Trainer` on the same global batches and draws: losses,
    the EMA's eval chain, a step after it, parameters and EMA within f32
    rel. L2 1e-5 (summation order only; the one-process Trainer is held
    against JAX in test_torch_trainer.py); the eval leaves the state bit
    for bit;
  * the FSDP state saved by the primary, loaded on both ranks and by one
    process, bit for bit;
  * patch-parallel sampling on two ranks against one, within the chain
    tests' atol/rtol 1e-5 (a rank's share runs at another batch size);
  * the training CLI with `--fsdp` on two ranks, then resumed on both.
"""

import multiprocessing
import queue as queue_mod
import socket

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import _torch_dist_worker as W
from localdiffusion_tpu.parallel.fsdp import spec_for_shape as jax_spec
from localdiffusion_tpu_torch.parallel import fsdp as F
from localdiffusion_tpu_torch.parallel import mesh as M
from localdiffusion_tpu_torch.parallel import multihost as H

REL = 1e-5
WORKER_TIMEOUT_S = 120


@pytest.mark.parametrize("shape,size", [
    ((), 2), ((7,), 2), ((8,), 2), ((1,), 2), ((3, 3, 16, 32), 4), ((3, 3, 15, 7), 4),
    ((64, 3), 8), ((5, 6), 3), ((2, 2), 4), ((128,), 1), ((4, 4), 16), ((32, 1, 1, 32), 2),
])
def test_spec_for_shape_matches_jax(shape, size):
    assert F.spec_for_shape(shape, "data", size) == tuple(jax_spec(shape, "data", size))
    assert PartitionSpec(*F.spec_for_shape(shape, "data", size)) == jax_spec(shape, "data", size)


def test_row_ranges_cover_the_batch():
    for n in (1, 5, 8, 9):
        for count in (1, 2, 3, 4):
            parts = [H.row_range(n, i, count) for i in range(count)]
            assert parts[0][0] == 0 and parts[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            assert max(b - a for a, b in parts) - min(b - a for a, b in parts) <= 1


def test_single_process_mesh_and_helpers():
    """One process: a (1, 1) mesh, every selection the whole array, the
    helpers no-ops; a tensor-parallel axis wider than the ranks refused."""
    mesh = M.make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "patch") and mesh.size() == 1
    x = np.arange(24).reshape(2, 3, 4)
    for sh in (M.replicated(mesh), M.batch_sharding(mesh), M.branch_batch_sharding(mesh)):
        np.testing.assert_array_equal(H.put_tree(x, sh), x)
    assert M.shard_batch(mesh, x, x)[1] is not None
    assert not H.is_multiprocess() and H.is_primary()
    H.sync()
    H.warmup_collectives()
    H.init_distributed(None, 1, 0)  # a no-op
    assert H.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match=r"not divisible by patch\*model=2"):
        M.make_mesh(model=2, device="cpu")
    info = F.shard_info([torch.zeros(4, 3)])
    assert info == {"global_bytes": 48, "per_device_bytes": 48, "memory_scaling": 1.0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_process() -> dict:
    """The one-process Trainer on the same batches and draws (one torch
    thread, as a worker has)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr, losses = W.train_steps()
        mse, _, loss = W.eval_then_step(tr)
        return dict(losses=losses + [loss], eval=mse, state=W.state_arrays(tr))
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Every job on two spawned ranks, once a module: ({rank: result},
    workdir, the one-process reference, computed while the ranks run).
    Every worker must answer within WORKER_TIMEOUT_S, else the tests fail
    (and the workers are killed)."""
    world, workdir = 2, tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=W.run, args=(r, world, port, str(workdir), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        reference = _one_process()
        for _ in range(world):
            rank, res = q.get(timeout=WORKER_TIMEOUT_S)
            if isinstance(res, str):
                pytest.fail(f"rank {rank}: {res}")
            results[rank] = res
    except queue_mod.Empty:
        pytest.fail(f"a worker gave no answer within {WORKER_TIMEOUT_S}s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results, workdir, reference


def _rel(got: dict, want: dict) -> float:
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in want])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def one_process(workers):
    return workers[2]


@pytest.mark.parametrize("kind", ["replicated", "fsdp"])
def test_two_ranks_train_as_one_process(one_process, workers, kind):
    res, workdir, _ = workers
    want = one_process
    for rank, ranks in res.items():
        got = ranks["group"][kind]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        # the EMA's eval chain, each rank its rows (under FSDP through the
        # model's units, the EMA's shards swapped in), leaves the state as it was
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=REL)
        assert got["eval_kept_state"]
        for part in ("params", "ema"):
            assert set(got["state"][part]) == set(want["state"][part])
            rel = _rel(got["state"][part], want["state"][part])
            assert rel <= REL, f"rank {rank} {part}: rel L2 {rel:.3g}"
    if kind == "fsdp":
        for rank, ranks in res.items():
            got = ranks["group"]
            # everything a rank holds (parameters, gradients, Adam, EMA)
            assert 1.8 < got["info"]["memory_scaling"] < 2.2
            # saved by the primary, loaded on every rank: the state bit for bit
            for part in ("params", "ema"):
                for k, v in got["fsdp"]["state"][part].items():
                    np.testing.assert_array_equal(got["reloaded"][part][k], v)
        # and by one process: the one-process layout
        from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
        from localdiffusion_tpu_torch.train.trainer import Trainer

        cfg = W.tiny_config()
        single = Trainer(build_gd(cfg, device="cpu"), cfg.train)
        single.results_dir = str(workdir)
        single.load("1")
        assert single.step == 4
        for k, v in single.model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), res[0]["group"]["fsdp"]["state"]["params"][k])
        np.testing.assert_array_equal(
            single.optimizer.state_dict()["state"][0]["exp_avg"].numpy(), res[1]["group"]["adam"])


def test_patch_sampling_on_two_ranks_is_one_rank_s(workers):
    from localdiffusion_tpu_torch.parallel.patch import patch_parallel_sample

    res, _, _ = workers
    gd, cfg = W.patch_engine()
    cond, mask = W.patch_inputs()
    want = patch_parallel_sample(gd, cond, mask, cfg.sampler, (0.0, 2.0), 16, 4, noise=9)
    for got in res.values():
        np.testing.assert_allclose(got["group"]["patch"], want.numpy(), rtol=1e-5, atol=1e-5)
    # every rank stitches the whole image
    np.testing.assert_array_equal(res[0]["group"]["patch"], res[1]["group"]["patch"])


def test_train_cli_fsdp_on_two_ranks_resumes(workers):
    """1 epoch step, then `--resume auto` to step 2: both ranks load the
    checkpoint the primary wrote; the log and checkpoints are the
    primary's."""
    res, workdir, _ = workers
    for rank, ranks in res.items():
        got = ranks["cli"]
        assert (got["rank"], got["world"], got["start"]) == (rank, 2, 1)
        assert len(got["first"]) == 1 and len(got["second"]) == 1
    assert res[0]["cli"]["second"] == res[1]["cli"]["second"]
    ckpt = torch.load(workdir / "cli" / "tiny" / "model-latest.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert (workdir / "cli" / "tiny" / "train_loss.csv").read_text().count("\n") == 3
