"""se_tpu_torch's "model" mesh axis on the CPU: gloo ranks whose model
groups split each kernel wrapper's leading axis (`parallel.map_leading`,
se_tpu's `shard_map_leading`), against one process and against se_tpu's
{"data": 2, "model": 2} mesh.

- Ranks: `tests/torch_parallel_worker.py DIR WORLD RANK 2`, spawned once
  for the module (test_torch_parallel.py's `_Ranks`): a world of 4 as
  {"data": 2, "model": 2} and a world of 2 as {"data": 1, "model": 2},
  each rank one thread. They run while the se_tpu test below compiles.
- Each of the six mapped wrappers (attention, the DSConv block and pair
  stage, the encoder and decoder levels, the LSTM layer with its carries;
  their CPU twins, float64) under the mesh against the unmapped call: its
  outputs and the gradients of every input, the replicated weights'
  included, within 1e-12 of the largest; at a leading axis of 4 each
  rank's share is 2 rows, at 3 (odd) the wrapper runs unmapped.
- The step cases of `torch_parallel_worker.MODEL_CASES` against the
  one-process run (test_torch_parallel.py's tolerances: loss 1e-5
  relative, gradients 1e-5 of the largest, BN statistics 1e-5 of max(1,
  max), the decode 1e-5 of max|ref|): Uformer at 2 x 2, two steps with
  dropout on and its decode of 4 utterances; DPCRN at 1 x 2 (the LSTM
  layer mapped with its carries), two steps and its decode of 3. Every
  rank ends with rank 0's weights, bit for bit.
- Against se_tpu: its `make_train_step` over `make_mesh({"data": 2,
  "model": 2}, devices=jax.devices()[:4])` (tests/test_trainer.py's
  model-sharded Uformer step) from the same weights, dropout off on both
  sides: the loss within 1e-5 relative and the gradients within 1e-5 of
  the largest.
- The rank layout (rank = data index x model + model index), the rows a
  rank holds, and the replica check holding every rank to rank 0;
  `shard_map_leading` returns None where the leading axis does not divide
  and `fn` itself on a model axis of 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import se_tpu.models.uformer  # noqa: F401  (flax's Dropout, patched)
from flax import linen as fnn
from se_tpu.parallel import activation_mesh as j_activation_mesh
from se_tpu.parallel import make_mesh as j_make_mesh
from se_tpu.parallel import shard_batch as j_shard_batch
from se_tpu.parallel.mesh import replicate as j_replicate
from se_tpu.train import trainer as jtrainer
from se_tpu_torch.models import get_model
from se_tpu_torch.parallel import Mesh, shard_map_leading
import torch_parallel_worker as W
from test_torch_parallel import _KeepGrads, _Ranks, _tolerances

LAYOUTS = ((4, 2), (2, 2))  # (world, model)
JAX_CASE = "uformer_model_jax"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("model_ranks"), LAYOUTS,
               {JAX_CASE: 4})
    yield r
    r.close()


def _loaded(ranks, stem: str, world: int) -> list:
    ranks.wait()
    return [torch.load(ranks.dir / f"{stem}_w{world}m2_rank{r}.pt",
                       weights_only=False) for r in range(world)]


# se_tpu first: its JAX compile runs while the ranks work
def test_model_axis_step_matches_se_tpu(monkeypatch, ranks):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jtrainer, "optax", _KeepGrads)
    case = W.MODEL_CASES[JAX_CASE]
    variables = ranks.variables[JAX_CASE]
    mesh = j_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    _, _, step_fn, _ = jtrainer.make_train_step(
        jtrainer.TrainConfig(model="uformer"), mesh=mesh)
    params = jax.tree.map(jnp.asarray, variables["params"])
    extra = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    batch = W.make_batch(JAX_CASE)
    with j_activation_mesh(mesh):
        state = j_replicate({
            "params": params, "extra_vars": extra,
            "opt_state": jax.tree.map(jnp.zeros_like, params),
            "step": jnp.zeros((), jnp.int32), "lr_scale": jnp.ones(()),
            "rng": jax.random.PRNGKey(0)}, mesh)
        new, loss = step_fn(state, j_shard_batch(
            {"mix": jnp.asarray(batch["mix"]),
             "clean": jnp.asarray(batch["clean"]),
             "frames": jnp.asarray(batch["frames"], jnp.int32)}, mesh))
    tree = {"params": jax.tree.map(np.asarray, new["opt_state"]),
            "batch_stats": jax.tree.map(np.asarray,
                                        new["extra_vars"]["batch_stats"])}
    want = {k: v.numpy() for k, v in
            get_model("uformer").from_jax_variables(tree).items()}
    every = ranks.results(JAX_CASE)
    assert len(every) == case["world"]
    for got in every:
        assert got["mapped_rows"], "no kernel call was mapped"
        step = got["steps"][0]
        np.testing.assert_allclose(step["loss"], float(loss), rtol=1e-5)
        gmax = max(np.abs(want[k]).max() for k in step["grads"])
        for key, g in step["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                       atol=1e-5 * gmax, err_msg=key)


@pytest.mark.parametrize("world", [w for w, _ in LAYOUTS])
@pytest.mark.parametrize("rows", [4, 3], ids=["mapped", "indivisible"])
@pytest.mark.parametrize("name", W.WRAPPERS)
def test_mapped_wrapper_equals_unmapped(ranks, name, rows, world):
    want = W.wrapper_case(name, rows, None)
    scale = max(float(t.abs().max()) for t in want["outputs"])
    gmax = max(float(g.abs().max()) for g in want["grads"])
    for rank, every in enumerate(_loaded(ranks, "wrappers", world)):
        got = every[(name, rows)]
        assert got["mapped_rows"] == ([rows // 2] if rows % 2 == 0 else [])
        for g, w in zip(got["outputs"], want["outputs"], strict=True):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * scale)
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"],
                                       strict=True)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * gmax,
                                       msg=f"rank {rank}, input {i}")


@pytest.mark.parametrize("name", [n for n in W.MODEL_CASES
                                  if n != JAX_CASE])
def test_model_axis_step_equals_one_process(ranks, name):
    case = W.MODEL_CASES[name]
    l_tol, g_tol, s_tol = _tolerances(case)
    ref = ranks.reference(name)
    every = ranks.results(name)
    for rank, got in enumerate(every):
        for k, (step, want) in enumerate(zip(got["steps"], ref["steps"],
                                             strict=True)):
            where = f"rank {rank}, step {k + 1}"
            np.testing.assert_allclose(step["loss"], want["loss"],
                                       rtol=l_tol, err_msg=where)
            gmax = max(float(g.abs().max()) for g in want["grads"].values())
            for key, g in want["grads"].items():
                np.testing.assert_allclose(
                    step["grads"][key].numpy(), g.numpy(), rtol=0,
                    atol=g_tol * gmax, err_msg=f"{where}: {key}")
            for key, b in want["buffers"].items():
                np.testing.assert_allclose(
                    step["buffers"][key].numpy(), b.numpy(), rtol=0,
                    atol=s_tol * max(1.0, float(b.abs().max())),
                    err_msg=f"{where}: {key}")
        np.testing.assert_allclose(
            got["enhance"], ref["enhance"], rtol=0,
            atol=1e-5 * np.abs(ref["enhance"]).max(), err_msg="enhance")
        assert got["enhance"].shape == (case["enhance"], W.N_SAMPLES)
        for key, w in got["weights"].items():
            assert torch.equal(w, every[0]["weights"][key]), (rank, key)
        assert got["mapped_rows"], "no kernel call was mapped"
    assert not ref["mapped_rows"]


@pytest.mark.parametrize("world", [w for w, _ in LAYOUTS])
def test_rank_layout_rows_and_replica_check(ranks, world):
    """se_tpu's row-major layout: rank r = i * model + j; a model group's
    ranks hold the same rows (its data coordinate's), the shards gather
    back to the batch, and the replica check names the last rank."""
    for rank, extra in enumerate(_loaded(ranks, "extras", world)):
        i, j = rank // 2, rank % 2
        assert extra == {"coords": (i, j), "rows": [4 * i + r
                                                    for r in range(4)],
                         "row_offset": 4 * i, "gathered": True,
                         "replicate_refused": True}, rank


def test_shard_map_leading_splits_only_where_it_divides():
    mesh = Mesh({"data": 1, "model": 2}, 1, "gloo")

    def fn(x, w):
        return x * w

    assert shard_map_leading(fn, mesh, 3, 1, 1) is None
    assert shard_map_leading(fn, mesh, 4, 1, 1) is not None
    assert shard_map_leading(fn, Mesh({"data": 2}, 1, "gloo"), 3, 1,
                             1) is fn
    assert (mesh.data_index, mesh.model_index, mesh.size) == (0, 1, 2)
