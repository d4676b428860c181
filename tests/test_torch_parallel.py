"""se_tpu_torch's data parallelism on the CPU: gloo ranks against the
port's one-process step and decode on the global batch, and against
se_tpu's mesh path.

- Ranks: `tests/torch_parallel_worker.py` (torch and the port only),
  spawned once for the module as separate interpreters: a world of 2 and
  a world of 3, each rank one thread, the group through a FileStore in a
  temporary directory. They run while the se_tpu tests below compute
  their JAX side.
- Each case of `torch_parallel_worker.CASES`, two train steps (the second
  under the sharded Adam state), against the one-process steps on the
  global batch: LSTMNet; DPCRN, a BN family, with unequal valid frames
  across the ranks; FullSubNet at B = 6 (shards of 3: the second starts
  at an odd global row, so drop_band's groups cross the shard); Uformer
  with dropout on; CRN under remat "dots"; LSTMNet in bf16 under remat
  "full"; DPCRN at world 3 with `enhance_waveform(mesh=)` at B = 4 (padded
  to 6, trimmed). The second one-process step starts from rank 0's state
  after the first: Adam's first update is +-lr on every weight whatever
  its gradient's size, so a gradient zero in exact arithmetic (a conv
  bias before BN) that holds round-off of either sign moves its weight
  2e-3 apart in two runs that sum in other orders.
  Tolerances, fp32: the loss 1e-5 relative; every gradient (before the
  clip) within 1e-5 x the step's largest |gradient|; BN running
  statistics within 1e-5 x max(1, max|stat|); enhance 1e-5 x max|ref|.
  bf16: the gradients within 2^-7 x the largest (one bf16 ulp: BN's
  global statistics sum in another order and a bf16 cast can round the
  other way). fp64 (DPCRN at world 3, see the worker): 1e-12 for all.
  Every rank ends with rank 0's weights, bit for bit.
- Against se_tpu: its `make_train_step(cfg, mesh=make_mesh({"data": 2},
  devices=jax.devices()[:2]))` on conftest's 8 CPU devices, from the same
  weights (`fill_tree`, carried in by `from_jax_variables`; no dropout in
  these families), for LSTMNet and DPCRN: the first step's loss (1e-5
  relative), gradients (1e-5 of the largest) and BN statistics; and
  DPCRN's `enhance_waveform(mesh=)` at B = 3 (1e-4 abs and rel).
- Refusals: a "model" axis that does not divide the world, a batch that
  does not divide, a mesh larger than the world; the backend by topology;
  `initialize_multihost` with nothing configured makes no group.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import se_tpu.models as jmodels
from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.parallel import activation_mesh as j_activation_mesh
from se_tpu.parallel import make_mesh as j_make_mesh
from se_tpu.parallel import shard_batch as j_shard_batch
from se_tpu.parallel.mesh import replicate as j_replicate
from se_tpu.train import trainer as jtrainer
from se_tpu_torch.models import get_model
from se_tpu_torch.parallel import (
    Mesh, initialize_multihost, make_mesh, shard_batch,
)
from se_tpu_torch.parallel.collectives import all_gather_rows, choose_backend
import torch_parallel_worker as W
from torch_kernel_inputs import fill_tree

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
SE_TPU_SEEDS = {"lstm": 3, "dpcrn": 3}  # the cases that start from se_tpu's


def _jax_variables(name: str, kw: dict, seed: int) -> dict:
    entry = jmodels.get_model(name)
    bins = get_model(name).stft.bins
    if entry.io_kind == "waveform":  # Uformer: (mix, clean)
        args = (np.zeros((1, W.N_SAMPLES), np.float32),) * 2
    elif entry.io_kind in ("mag_mask", "cirm"):
        args = (np.zeros((1, 16, bins), np.float32),)
    else:
        args = (np.zeros((1, 16, bins, 2), np.float32),)
    return fill_tree(jax.eval_shape(entry.make(**kw).init,
                                    jax.random.PRNGKey(0), *args), seed)


class _Ranks:
    """The spawned ranks, a group a layout (world, model: 0 for a "data"
    mesh); `results(name)` waits for them once, then returns each rank's
    result of case `name`; `reference(name)` the one-process run. The
    cases of `seeds` start from se_tpu's weights drawn from the seed."""

    def __init__(self, out_dir: Path, layouts=((2, 0), (3, 0)),
                 seeds=SE_TPU_SEEDS):
        self.dir = out_dir
        self.variables = {}
        for name, seed in seeds.items():
            case = W.case(name)
            self.variables[name] = _jax_variables(case["model"], case["kw"],
                                                  seed)
            torch.save(get_model(case["model"]).from_jax_variables(
                self.variables[name]), out_dir / f"{name}_weights.pt")
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out_dir), str(world),
             str(rank), *([str(model)] if model else [])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for world, model in layouts for rank in range(world)]
        self.done = False
        self.refs = {}

    def wait(self) -> None:
        if self.done:
            return
        logs = [p.communicate(timeout=600)[0].decode() for p in self.procs]
        self.done = True
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, log[-4000:]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self, name: str) -> list:
        self.wait()
        return [torch.load(self.dir / f"{name}_rank{r}.pt",
                           weights_only=False)
                for r in range(W.case(name)["world"])]

    def extras(self) -> list:
        self.wait()
        return [torch.load(self.dir / f"extras_rank{r}.pt") for r in
                range(3)]

    def reference(self, name: str) -> dict:
        if name not in self.refs:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                self.refs[name] = W.run_case(
                    name, None, str(self.dir),
                    resume=self.results(name)[0]["state1"])
            finally:
                torch.set_num_threads(threads)
        return self.refs[name]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


class _KeepGrads:
    """optax as se_tpu's trainer calls it, but its chain returns zero
    updates and keeps the gradients as its state."""

    clip_by_global_norm = staticmethod(lambda max_norm: None)
    scale_by_adam = staticmethod(lambda: None)

    @staticmethod
    def chain(*parts):
        return optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda g, state, params=None: (
                jax.tree.map(jnp.zeros_like, g), g))


def _two_devices():
    return j_make_mesh({"data": 2}, devices=jax.devices()[:2])


# se_tpu first: its JAX compiles run while the ranks work
@pytest.mark.parametrize("name", sorted(SE_TPU_SEEDS))
def test_sharded_step_matches_se_tpu(monkeypatch, ranks, name):
    case = W.CASES[name]
    variables = ranks.variables[name]
    monkeypatch.setattr(jtrainer, "optax", _KeepGrads)
    mesh = _two_devices()
    _, _, step_fn, _ = jtrainer.make_train_step(
        jtrainer.TrainConfig(model=case["model"], model_kwargs=case["kw"]),
        mesh=mesh)
    params = jax.tree.map(jnp.asarray, variables["params"])
    extra = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    state = j_replicate({
        "params": params, "extra_vars": extra,
        "opt_state": jax.tree.map(jnp.zeros_like, params),
        "step": jnp.zeros((), jnp.int32), "lr_scale": jnp.ones(()),
        "rng": jax.random.PRNGKey(0)}, mesh)
    batch = W.make_batch(name)
    with j_activation_mesh(mesh):
        new, loss = step_fn(state, j_shard_batch(
            {"mix": jnp.asarray(batch["mix"]),
             "clean": jnp.asarray(batch["clean"]),
             "frames": jnp.asarray(batch["frames"], jnp.int32)}, mesh))
    tree = {"params": jax.tree.map(np.asarray, new["opt_state"])}
    if "batch_stats" in new["extra_vars"]:
        tree["batch_stats"] = jax.tree.map(np.asarray,
                                           new["extra_vars"]["batch_stats"])
    want = {k: v.numpy() for k, v in
            get_model(case["model"]).from_jax_variables(tree).items()}
    gmax = max(np.abs(v).max() for k, v in want.items()
               if "running" not in k)
    for got in ranks.results(name):
        step = got["steps"][0]
        np.testing.assert_allclose(step["loss"], float(loss), rtol=1e-5)
        for key, g in step["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                       atol=1e-5 * gmax, err_msg=key)
        for key, b in step["buffers"].items():
            if key in want:  # BN statistics; an LSTM's zero bias_hh not
                np.testing.assert_allclose(
                    b.numpy(), want[key], rtol=0,
                    atol=1e-5 * max(1.0, np.abs(want[key]).max()),
                    err_msg=key)


def test_sharded_enhance_matches_se_tpu(ranks):
    """DPCRN's decode at B = 3 over two devices (padded to 4, trimmed),
    se_tpu's against the ranks'."""
    x = W.enhance_input(W.CASES["dpcrn"]["enhance"])
    want = j_enhance_waveform("dpcrn", jax.tree.map(
        jnp.asarray, ranks.variables["dpcrn"]), x,
        model=jmodels.get_model("dpcrn").make(), mesh=_two_devices())
    for got in ranks.results("dpcrn"):
        np.testing.assert_allclose(got["enhance"], want, rtol=1e-4,
                                   atol=1e-4)


def _tolerances(case: dict) -> tuple:
    """(loss rtol, gradient share of the largest, statistic share)."""
    if case.get("fp64"):
        return 1e-12, 1e-12, 1e-12
    if case.get("compute_dtype") == "bf16":
        return 1e-5, 2.0 ** -7, 1e-5
    return 1e-5, 1e-5, 1e-5


@pytest.mark.parametrize("name", list(W.CASES))
def test_sharded_step_equals_one_process(ranks, name):
    case = W.CASES[name]
    l_tol, g_tol, s_tol = _tolerances(case)
    ref = ranks.reference(name)
    every = ranks.results(name)
    for rank, got in enumerate(every):
        for k, (step, want) in enumerate(zip(got["steps"], ref["steps"])):
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
        if "enhance" in ref:
            np.testing.assert_allclose(
                got["enhance"], ref["enhance"], rtol=0,
                atol=1e-5 * np.abs(ref["enhance"]).max(), err_msg="enhance")
            assert got["enhance"].shape == (case["enhance"], W.N_SAMPLES)
        for key, w in got["weights"].items():
            assert torch.equal(w, every[0]["weights"][key]), (rank, key)


def test_world_three_gathers_and_checks_replicas(ranks):
    for rank, extra in enumerate(ranks.extras()):
        assert extra == {"gathered": True, "replicate_refused": True}, rank


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2}, {"model": 3}])
def test_model_axis_must_divide_the_world(axes):
    """A "model" axis above 1 is a mesh like any other: its product with
    "data" is the world (here one process), or it raises."""
    with pytest.raises(ValueError, match="1 ranks"):
        make_mesh(axes)


def test_mesh_must_cover_the_world():
    with pytest.raises(ValueError, match="1 ranks"):
        make_mesh({"data": 2})
    mesh = make_mesh()
    assert mesh.shape == {"data": 1} and mesh.rank == 0


def test_initialize_multihost_is_a_no_op_unconfigured(monkeypatch):
    """Single process, no address and no launcher: no group is made, and
    the mesh is a world of one whose collectives are its inputs."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost() is None
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2)
    mesh = make_mesh()
    assert torch.equal(shard_batch(x, mesh), x)
    assert torch.equal(all_gather_rows(x, mesh), x)


def test_batch_that_does_not_divide_raises():
    mesh = Mesh({"data": 2}, 1, "gloo")
    rows = shard_batch({"x": torch.arange(4)}, mesh)["x"]
    assert rows.tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": torch.zeros(3, 5)}, mesh)


@pytest.mark.parametrize("kind, ranks_per_host, cards, want", [
    ("cpu", 3, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl")])
def test_backend_by_topology(kind, ranks_per_host, cards, want):
    assert choose_backend(kind, ranks_per_host, cards) == want
