"""Mesh serving on the CPU: `LocalDiffusionPipeline(mesh=...)` and
`InferenceServer` over a ('data', 'patch') mesh of two gloo ranks, against
the port's one-process pipeline, and that one against the JAX pipeline
over its eight-device mesh.

One spawn of two workers (`_torch_dist_worker.run_mesh`: JAX blocked, one
torch thread each, each answer within WORKER_TIMEOUT_S or the test fails
and the workers are killed) serves the file.  On each mesh, data = 2 ×
patch = 1 and data = 1 × patch = 2, every rank runs a narrow flagship
(`mesh_config`: dim 8, 12px, f32, seeded weights) through:

  * the branched DDPM chain with Stage A (the manual detector, on the
    first rank, its mask broadcast) and the metrics;
  * the gated DDPM chain with a scripted classifier (rows 2-3 rejected
    until the retry budget, so on data = 2 one rank latches before the
    other);
  * the branched DDIM chain;
  * `InferenceServer` with 4 requests (the first rank serves, the other
    follows), after its warm-up;

each held against the one-process pipeline within atol/rtol 1e-5 (a
rank's share runs at another batch size), every rank's result dict the
same; an indivisible batch raises "not divisible", in `translate` and at
the server's construction, and ranks holding other weights are refused.
The one-process pipeline is held against JAX `LocalDiffusionPipeline(
mesh=mesh8)` on the replayed JAX key stream at JAX's own atol 1e-4
(`tests/test_serving.py`).
"""

import multiprocessing
import queue as queue_mod
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.serving import InferenceServer
from test_torch_support import branched_noise, jax_config, make_pair, plain_noise, retry_noise

TOL = dict(rtol=1e-5, atol=1e-5)
WORKER_TIMEOUT_S = 120
KEY = jax.random.PRNGKey(21)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX engine, its params, the port's weights file): the JAX init,
    perturbed, carried into the port."""
    cfg = W.mesh_config("ddpm")
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=7)
    path = str(tmp_path_factory.mktemp("mesh") / "weights.pt")
    torch.save(tgd.model.state_dict(), path)
    return jgd, params, path


def _one_process(weights) -> dict:
    """The one-process pipeline on the same inputs and seeds (one torch
    thread, as a worker has)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {c: W.mesh_translate(W.mesh_pipeline(c, weights), c) for c in W.CHAINS}
        out["served"] = np.stack(W.mesh_serve(W.mesh_pipeline("ddpm", weights)))
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(pair):
    """({rank: results}, the one-process results, computed while the ranks
    run)."""
    world = 2
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=W.run_mesh, args=(r, world, port, pair[2], q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        reference = _one_process(pair[2])
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
    return results, reference


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("chain", W.CHAINS)
def test_mesh_translate_is_one_process(ranks, mesh, chain):
    res, want = ranks
    want = want[chain]
    for rank in res:
        got = res[rank][mesh][chain]
        assert set(got) == set(want), rank
        for k, v in want.items():
            if k in ("mask", "branched", "fusion_time"):
                np.testing.assert_array_equal(got[k], v, err_msg=f"rank {rank} {k}")
            else:
                np.testing.assert_allclose(got[k], v, **TOL, err_msg=f"rank {rank} {k}")
    # every rank returns the same result
    for k in want:
        np.testing.assert_array_equal(res[0][mesh][chain][k], res[1][mesh][chain][k])
    assert bool(want["branched"])
    if chain == "gated":
        assert want["fusion_time"].tolist() == [3, 3, 1, 1]


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_mesh_server_is_one_process(ranks, mesh):
    res, want = ranks
    np.testing.assert_allclose(res[0][mesh]["served"], want["served"], **TOL)
    assert res[1][mesh]["followed"] == 3  # the warm-up's two and the merged batch


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_mesh_refuses_indivisible_batches(ranks, mesh):
    res, _ = ranks
    for rank in res:
        if mesh == "2x1":
            assert "not divisible" in res[rank][mesh]["indivisible"]
            assert "not divisible" in res[rank][mesh]["server_indivisible"]
        else:  # data width 1 divides every batch
            assert "indivisible" not in res[rank][mesh]
    assert all("different denoiser weights" in res[r]["weights_differ"] for r in res)


def test_one_process_mesh_pipeline_and_server(pair):
    """A mesh of one rank (gloo over an in-memory store) serves as the plain
    pipeline does, bit for bit."""
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    for chain in ("ddpm", "ddim"):
        got = W.mesh_translate(W.mesh_pipeline(chain, pair[2], mesh), chain)
        want = W.mesh_translate(W.mesh_pipeline(chain, pair[2]), chain)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(RuntimeError, match="other ranks"):
        InferenceServer(W.mesh_pipeline("ddpm", pair[2], mesh), batch_size=4).follow()


def _jax_pipe(pair, chain, mesh8):
    jgd, params, _ = pair
    cfg = W.mesh_config(chain)
    jc = jax_config(cfg)
    if chain == "ddim":  # a DDIM engine over the same weights
        from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion

        jgd = GaussianDiffusion(jc.model, jc.diffusion)
    gate = None
    if chain == "gated":
        table = jnp.asarray(W.gate_table(cfg.diffusion.timesteps))
        gate = lambda xs, t: jnp.where(table[t], -1.0, 1.0)  # noqa: E731
    return JaxPipeline(jc, jgd, params, classifier_gate=gate, mesh=mesh8), cfg


@pytest.mark.parametrize("chain", W.CHAINS)
def test_one_process_port_is_the_jax_mesh_pipeline(pair, mesh8, chain):
    jpipe, cfg = _jax_pipe(pair, chain, mesh8)
    lr, hr, mask = W.mesh_inputs()
    want = jpipe.translate(lr, hr=hr, key=KEY, mask=mask)
    shape = (W.MESH_B, W.MESH_S, W.MESH_S, 1)
    T, s = cfg.diffusion.timesteps, cfg.sampler.start_timestep
    retry = None
    if chain == "ddim":
        noise = plain_noise(KEY, shape, cfg.diffusion.sampling_timesteps)
    else:
        noise = branched_noise(KEY, shape, T, s)
    if chain == "gated":
        ft = np.asarray(want["fusion_time"])
        retry = ArrayNoise(retry_noise(KEY, shape, T, s, s - int(ft.min())), "cpu")
    got = W.mesh_pipeline(chain, pair[2]).translate(lr, hr=hr, noise=ArrayNoise(noise, "cpu"),
                                                    retry_noise=retry, mask=mask)
    assert set(got) == set(want)
    for k in ("pred", "mse", "ssim", "psnr"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, err_msg=k)
    if chain == "gated":
        np.testing.assert_array_equal(got["fusion_time"], want["fusion_time"])
