"""Tensor parallelism over the 'model' axis on the CPU: `make_mesh(model=2)`,
`tp_param_shardings` and the sharded compute of
`parallel.tensor_parallel`, against the JAX package's
(`tests/test_fsdp.py::test_tp_forward_parity`).

One spawn of two gloo ranks (`_torch_dist_worker.run_tp`: JAX blocked, one
torch thread each, each answer within WORKER_TIMEOUT_S or the test fails
and the workers are killed) serves the file.  Each rank builds the port's
engine on `tests/test_fsdp.py`'s config (dim 8, mults 1/2, 8px, pred_x0)
with the JAX init's weights carried across, shards it over model = 2 and
runs `apply_model`; each rank's output is held to JAX's replicated
`apply_model` at JAX's own rtol 2e-4 / atol 2e-5, each leaf's spec to
JAX's `tp_param_shardings`, each rank's shard to the elements JAX places
on a device of its 'model' coordinate, and its resident parameter bytes
to at most 1/1.8 of the whole.  A pipeline on the model mesh, handed a
sharded denoiser, gathers it whole and translates as one process does.
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
from localdiffusion_tpu.config import DiffusionConfig, ModelConfig
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu.parallel import make_mesh as jax_make_mesh
from localdiffusion_tpu.parallel import tp_param_shardings as jax_tp_param_shardings
from localdiffusion_tpu_torch.parallel import tensor_parallel as TP
from localdiffusion_tpu_torch.utils.params_io import params_from_jax, torch_leaf
from test_torch_support import make_pair

WORLD = 2
WORKER_TIMEOUT_S = 120
TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_fsdp.py:163-164


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_side():
    """tests/test_fsdp.py's engine, params (PRNGKey(0), batch 1) and its
    replicated apply_model output."""
    gd = GaussianDiffusion(
        ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1),
        DiffusionConfig(image_size=W.TP_S, timesteps=10, objective="pred_x0"))
    params = gd.init_params(jax.random.PRNGKey(0), batch_size=1)
    x, cond, t = (jnp.asarray(a) for a in W.tp_inputs())
    ref = np.asarray(gd.apply_model(params, x, cond, t.astype(jnp.int32)))
    return gd, params, ref


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """{rank: results} of the two workers, and the one-process pipeline's
    translate, computed while they run."""
    from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion as TorchGD

    _, params, _ = jax_side
    tmp = tmp_path_factory.mktemp("tp")
    mcfg, dcfg = W.tp_config()
    model = TorchGD(mcfg, dcfg, device="cpu").model
    weights = str(tmp / "weights.pt")
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model), weights)
    cfg = W.mesh_config("ddim")
    pipe_weights = str(tmp / "pipe.pt")
    torch.save(make_pair(cfg.model, cfg.diffusion, seed=7)[2].model.state_dict(), pipe_weights)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=W.run_tp, args=(r, WORLD, port, weights, pipe_weights, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = W.mesh_translate(W.mesh_pipeline("ddim", pipe_weights), "ddim")
        finally:
            torch.set_num_threads(n)
        for _ in range(WORLD):
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
    return results, one


def test_make_mesh_has_the_model_axis(ranks):
    res, _ = ranks
    for r in res.values():
        assert r["mesh"] == ["data", "patch", "model"] and r["shape"] == [1, 1, WORLD]


@pytest.mark.parametrize("rank", range(WORLD))
def test_tp_apply_model_matches_jax(jax_side, ranks, rank):
    res, _ = ranks
    np.testing.assert_allclose(res[rank]["apply"], jax_side[2], **TOL)
    info = res[rank]["info"]
    assert info["memory_scaling"] >= 1.8, info


def test_tp_param_shardings_match_jax_leaf_by_leaf(jax_side, ranks, mesh8):
    """Each leaf's spec is JAX's on the converted parameters, and each
    rank's shard holds the elements JAX puts on a device whose 'model'
    coordinate is the rank."""
    _, params, _ = jax_side
    res, _ = ranks
    mesh = jax_make_mesh(data=4, patch=1, model=WORLD)
    jsh = jax_tp_param_shardings(params, mesh, "model")
    flat_p = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_s = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_leaves_with_path(jsh)}
    assert len(flat_p) == len(res[0]["specs"])
    sharded = 0
    for path, arr in flat_p.items():
        name, _ = torch_leaf(path, arr)
        sh = flat_s[path]
        spec = tuple(sh.spec) + (None,) * (arr.ndim - len(tuple(sh.spec)))
        got_spec, dim = res[0]["specs"][name]
        assert tuple(got_spec) + (None,) * (arr.ndim - len(got_spec)) == spec, (name, spec)
        sharded += dim is not None
        idx = sh.devices_indices_map(arr.shape)
        coords = {d: c for c, d in np.ndenumerate(mesh.devices)}
        for rank in range(WORLD):
            dev = next(d for d in idx if coords[d][2] == rank)
            _, want = torch_leaf(path, arr[idx[dev]])
            np.testing.assert_array_equal(res[rank]["local"][name], want, err_msg=name)
    assert sharded > len(flat_p) // 2


def test_model_mesh_pipeline_is_one_process(ranks):
    res, one = ranks
    for rank in res:
        assert res[rank]["replicated"] == 1.0
        got = res[rank]["translate"]
        assert set(got) == set(one)
        for k in one:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_shardings_from_shapes_alone():
    """The rule on the JAX leaf shape: a conv's O (torch dim 0), the input
    channels where O does not divide, a dense kernel's O, small and odd
    leaves whole."""
    class Mesh:
        def __getitem__(self, _axis):
            return type("Axis", (), {"size": staticmethod(lambda: 2)})()

    from localdiffusion_tpu_torch.models.blocks import Conv2d, Linear

    m = torch.nn.Module()
    m.a = Conv2d(8, 6, 3)
    m.b = Conv2d(8, 1, 1)
    m.c = Linear(4, 8)
    m.d = Conv2d(3, 3, 3)
    got = {k: (v.spec, v.dim) for k, v in TP.tp_param_shardings(m, Mesh()).items()}
    assert got == {
        "a.weight": ((None, None, None, "model"), 0), "a.bias": (("model",), 0),
        "b.weight": ((None, None, "model", None), 1), "b.bias": ((), None),
        "c.weight": ((None, "model"), 0), "c.bias": (("model",), 0),
        "d.weight": ((), None), "d.bias": ((), None)}
