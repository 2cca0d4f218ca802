"""Data parallelism of the port (``consolver_torch/dist/``) over 2 and 4 gloo
processes on the CPU, held against the JAX package on its 8-device virtual
CPU mesh sliced with ``make_mesh(num_devices=n)`` and against the port's
own one-process runs.

Each mesh size spawns its ranks once (``dist.launch.spawn``, about 5 s) and
runs every case there (``tests/torch_dist_workers.py::dp_suite_rank``); the
tests read the ranks' results.  Tiny f32 stacks, the same weights and inputs
(numpy, from seeds) on both sides.  Tolerances:

* rollouts: the port's sharded program against the JAX one-device program
  2e-4 (the 3-step CFG-3 tiny stack, as ``tests/test_torch_pipeline.py``);
  against the port's unsharded program, with the same actions, 1e-5 of the
  largest latent (the UNet runs at another batch size and thread count,
  which reorders f32 sums, and CFG 3 amplifies them);
* the PPO update: the global masked mean's loss and gradients against
  ``jax.value_and_grad`` 1e-5 (``tests/test_torch_ppo.py``); against the
  port's one-process update 1e-6;
* one trainer step against the JAX mesh trainer with the JAX actions
  injected: ``tests/test_torch_train.py``'s limits (rewards 2e-3 dB, loss
  and its aux 2e-3, parameters 1e-6 where the gradient is clear of 0,
  else within ``2 lr``); against the port's one-process trainer at
  ``num_groups = dp``, with the same sampled actions, the same limits: the
  policy loss is a mean of ``+-A * ratio`` over each group, near 0, so
  the ratio's last bits (the policy runs at another batch size) move it by
  about 1e-4;
* across ranks, post-update parameters are bit-equal.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.data import tokenizer as ttok
from consolver_torch.dist import launch
from consolver_torch.dist import mesh as meshlib
from consolver_torch.eval import consistency as tcons
from consolver_torch.eval.gen_sweep import save_png
from consolver_torch.rewards.registry import make_reward_fn
from consolver_torch.rl import ppo as tppo
from consolver_torch.rl import train as ttrain
from consolver_tpu.dist import mesh as jmesh
from consolver_tpu.eval import consistency as jcons
from consolver_tpu.rewards import metrics as jmetrics
from consolver_tpu.rl import ppo as jppo
from consolver_tpu.rl import train as jtrain
from tests import torch_dist_workers as workers
from tests.test_torch_pipeline import PROMPTS, TOL, _pipelines, stacks  # noqa: F401  (fixture)
from tests.test_torch_ppo import _policies, _ppo_batch, _torch_tree

FNET = dict(order_dim=4, scaler_dim=0, num_actions=11, family="sd")
TRAIN_FIELDS = dict(min_inference_steps=2, max_inference_steps=4, seed=0)
LR = 1e-3
ROWS = 8
UPDATE_ROWS = 32
LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
SAME_TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    return {
        "noise": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "latent": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "prompt_ids": rng.integers(1, 50, (rows, 4)).astype(np.int64),
    }


def _padded_valid(dp):
    """Row validity of a padded program whose shards hold different counts."""
    valid = np.ones((UPDATE_ROWS, 1), np.float32)
    per = UPDATE_ROWS // dp
    valid[:5] = 0  # shard 0 keeps per - 5 rows
    valid[per:per + 1] = 0  # shard 1 keeps per - 1
    return valid


def _jax_mesh_step(stacks, dp):  # noqa: F811
    """One JAX mesh trainer step at num_groups = dp: its metrics and the
    global trajectory's actions."""
    jpipe, _ = _pipelines(stacks, FNET)
    cfg = jtrain.TrainConfig(**TRAIN_FIELDS, output_dir="unused",
                             ppo=jppo.PPOConfig(ppo_epochs=1, learning_rate=LR))
    trainer = jtrain.PPOTrainer(jpipe, jmetrics.image_psnr_reward, cfg,
                                mesh=jmesh.make_mesh(num_devices=dp))
    captured = {}
    flatten = jppo.flatten_trajectory

    def record(traj, advantages):
        captured["actions"] = np.asarray(traj.actions)
        captured["advantages"] = np.asarray(advantages)
        return flatten(traj, advantages)

    jppo.flatten_trajectory = record
    try:
        metrics = trainer.train_step(_batch())
    finally:
        jppo.flatten_trajectory = flatten
    assert trainer.num_groups == dp
    return metrics, captured, trainer


def _pngs(root):
    gen, ref = root / "gen", root / "ref"
    gen.mkdir()
    ref.mkdir()
    rng = np.random.default_rng(5)
    for i in range(11):  # not divisible by 2 or 4
        save_png(str(gen / f"{i}.png"), rng.random((8, 8, 3)).astype(np.float32))
        save_png(str(ref / f"{i}.png"), rng.random((8, 8, 3)))
    return str(gen), str(ref)


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def suite(request, stacks, tmp_path_factory):  # noqa: F811
    """Every case's inputs, the ranks' results and the references."""
    dp = request.param
    tmp = tmp_path_factory.mktemp(f"dist{dp}")
    _, tpipe = _pipelines(stacks, FNET)
    models = (tpipe.unet, tpipe.text_encoder, tpipe.vae, tpipe.factor_net)
    ids = ttok.tokenize_batch(ttok.HashTokenizer(), (PROMPTS * 4)[:ROWS], 77, vocab_size=1000)
    noise = np.random.default_rng(11).standard_normal((ROWS, 8, 8, 4)).astype(np.float32)
    jnet, jparams, tnet = _policies(seed=3)
    x, actions, old, adv, _ = _ppo_batch(jnet, jparams, np.random.default_rng(6), n=UPDATE_ROWS)
    update = {"net": pickle.dumps(tnet), "x": x["x"], "actions": actions, "old": old,
              "adv": adv * 3.0, "valid": _padded_valid(dp)}
    j_metrics, j_cap, _ = _jax_mesh_step(stacks, dp)
    gen_dir, ref_dir = _pngs(tmp)
    payload = pickle.dumps({
        "dp": dp, "models_blob": pickle.dumps(models), "ids": ids, "noise": noise,
        "update": update, "train_fields": TRAIN_FIELDS, "batch": _batch(),
        "jax_actions": j_cap["actions"], "gen_dir": gen_dir, "ref_dir": ref_dir, "tmp": str(tmp),
    })
    ranks = launch.spawn(workers.dp_suite_rank, dp, timeout_s=120, args=(payload,))
    return {"dp": dp, "ranks": ranks, "models": models, "ids": ids, "noise": noise,
            "update": update, "jax": (jnet, jparams, j_metrics, j_cap), "tmp": tmp,
            "pngs": (gen_dir, ref_dir)}


def _assert_params_close(params, grads, want, lr):
    """Parameters after one Adam step (about ``lr * sign(g)``): equal where
    the gradient is clear of 0; an element whose gradient is below 1e-3 of
    its tensor's largest may take the other sign, moving by up to ``2 lr``."""
    for name, p in params.items():
        diff = np.abs(p - want[name])
        far = diff > 1e-6 + 1e-6 * np.abs(want[name])
        g = np.abs(grads[name])
        assert not (far & (g >= 1e-3 * g.max())).any(), name
        assert (diff <= 2 * lr * 1.01).all(), name


def _bit_equal_across_ranks(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        for name, value in get(r).items():
            np.testing.assert_array_equal(value, first[name], err_msg=name)


# ----------------------------------------------------------------- layout
def test_mesh_layout_matches_jax(suite):
    """Rank r is data rank r of a 1-D mesh, as JAX's device order."""
    dp = suite["dp"]
    devices = [d.id for d in jmesh.make_mesh(num_devices=dp).devices.reshape(-1)]
    for rank, out in enumerate(suite["ranks"]):
        lay = out["layout"]
        assert lay["shape"] == {"data": dp} and lay["backend"] == "gloo"
        assert (lay["data_rank"], lay["model_rank"]) == (devices.index(rank), 0)
        assert lay["data_ranks"] == list(range(dp)) and lay["model_ranks"] == [rank]


def test_shard_helpers_slice_contiguously():
    mesh = meshlib.Mesh(rank=3, world=4, dp=4, tp=1, data_rank=3, model_rank=0, data_group=None,
                        model_group=None, device=torch.device("cpu"), backend="gloo")
    tree = {"a": np.arange(8), "b": (torch.arange(16).reshape(8, 2),)}
    got = meshlib.shard_batch(mesh, tree)
    np.testing.assert_array_equal(got["a"], [6, 7])
    assert torch.equal(got["b"][0], torch.tensor([[12, 13], [14, 15]]))
    with pytest.raises(ValueError, match="divide"):
        meshlib.shard_batch(mesh, np.arange(6))
    assert meshlib.resolve_num_groups(None, mesh) == 4 and meshlib.resolve_num_groups(3, mesh) == 3
    assert meshlib.resolve_num_groups(None, None) == 1


# ---------------------------------------------------------------- rollout
def test_sharded_rollout_matches_replicated(suite, stacks):  # noqa: F811
    """The counterpart of tests/test_dist.py:23: the batch-sharded program
    equals the unsharded one, the port's and the JAX package's."""
    jpipe, _ = _pipelines(stacks, FNET)
    ids, noise = suite["ids"], suite["noise"]
    j_lat, j_traj = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise),
                          num_inference_steps=3, deterministic_policy=True, decode=False)
    tpipe = workers._sd_pipeline(suite["models"])
    with torch.no_grad():
        t_lat, _ = tpipe(None, ids, noise, num_inference_steps=3, deterministic_policy=True,
                         decode=False)
        s_lat, s_traj = tpipe(torch.Generator().manual_seed(3), ids, noise,
                              num_inference_steps=3, decode=False)
    for out in suite["ranks"]:
        mode, sampled = out["rollouts"]["mode"], out["rollouts"]["sampled"]
        np.testing.assert_allclose(mode["latents"], np.asarray(j_lat), **TOL)
        np.testing.assert_array_equal(mode["actions"], np.asarray(j_traj.actions))
        np.testing.assert_allclose(mode["latents"], t_lat.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(t_lat.numpy()).max())
        # sampled: each shard keeps its rows of the global draw
        np.testing.assert_array_equal(sampled["actions"], s_traj.actions.numpy())
        np.testing.assert_allclose(sampled["latents"], s_lat.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(s_lat.numpy()).max())
    assert len(np.unique(s_traj.actions.numpy().reshape(ROWS, -1), axis=0)) > 1


# ----------------------------------------------------------------- update
def _one_process_update(update):
    net = pickle.loads(update["net"])
    opt = tppo.make_optimizer(net, tppo.PPOConfig(learning_rate=LR, entropy_coef=0.01))
    aux = tppo.make_update_fn(net, opt, opt.config)(
        {"x": torch.from_numpy(update["x"])},
        *(torch.from_numpy(update[k]) for k in ("actions", "old", "adv", "valid")))
    return aux, {n: p.detach().numpy() for n, p in net.named_parameters()}, {
        n: p.grad.numpy() for n, p in net.named_parameters()}


def test_dp_update_is_the_global_masked_mean(suite):
    """The shards hold different valid counts; the DP loss and gradients are
    those of the global masked mean (JAX's mesh update), which an average of
    per-rank means is not."""
    jnet, jparams, _, _ = suite["jax"]
    u = suite["update"]
    per_rank_rows = [out["update"]["valid_rows"] for out in suite["ranks"]]
    assert len(set(per_rank_rows)) > 1

    def jloss(p, rows=slice(None)):
        return jppo.ppo_loss(jnet, p, {"x": jnp.asarray(u["x"][rows])},
                             jnp.asarray(u["actions"][rows]), jnp.asarray(u["old"][rows]),
                             jnp.asarray(u["adv"][rows]), 0.2, 0.01,
                             valid=jnp.asarray(u["valid"][rows]))

    (j_loss, j_aux), j_grads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    per = UPDATE_ROWS // suite["dp"]
    naive = np.mean([float(jloss(jparams, slice(r * per, (r + 1) * per))[0])
                     for r in range(suite["dp"])])
    assert abs(naive - float(j_loss)) > 1e-3
    want = workers.to_numpy(_torch_tree(pickle.loads(u["net"]), j_grads))
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in want.values())))
    assert norm > 1.0  # the optimizer clips the synced gradient (max norm 1): .grad holds g / norm
    for out in suite["ranks"]:
        aux = out["update"]["aux"]
        for name in ("loss", "policy_loss", "entropy", "ratio_mean"):
            np.testing.assert_allclose(aux[name], float(j_aux[name]), err_msg=name, **SAME_TOL)
        np.testing.assert_allclose(aux["grad_norm"], norm, rtol=1e-5)
        for name, g in out["update"]["grads"].items():
            np.testing.assert_allclose(g, want[name] / norm, err_msg=name, **SAME_TOL)


def test_dp_update_matches_single_process(suite):
    """The counterpart of tests/test_dist.py:61: DP update = one-process
    update, with the gradient norm and the clip after the sync."""
    aux, params, grads = _one_process_update(suite["update"])
    for out in suite["ranks"]:
        for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm"):
            np.testing.assert_allclose(out["update"]["aux"][name], float(aux[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        _assert_params_close(out["update"]["params"], grads, params, LR)
    _bit_equal_across_ranks(suite["ranks"], lambda out: out["update"]["params"])


def test_assert_params_synced(suite):
    """The counterpart of tests/test_dist.py:121: the global parameter sum,
    the same on every rank."""
    sums = {out["update"]["param_sum"] for out in suite["ranks"]}
    assert len(sums) == 1
    want = sum(float(np.asarray(p, np.float64).sum())
               for p in suite["ranks"][0]["update"]["params"].values())
    np.testing.assert_allclose(sums.pop(), want, rtol=1e-12)


# ---------------------------------------------------------------- trainer
def test_trainer_with_mesh_matches_jax_mesh_trainer(suite):
    """The counterpart of tests/test_dist.py:127, against the JAX trainer on
    make_mesh(num_devices=dp) at its default num_groups = dp, with the JAX
    actions injected into every rank's rows."""
    _, _, j_metrics, j_cap = suite["jax"]
    for out in suite["ranks"]:
        t = out["trainers"]["injected"]
        assert t["steps"] == j_cap["actions"].shape[1] + 1
        assert t["metrics"]["num_inference"] == j_metrics["num_inference"]
        for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward"):
            np.testing.assert_allclose(t["metrics"][name], j_metrics[name], err_msg=name,
                                       **LOSS_TOL)
    _bit_equal_across_ranks(suite["ranks"], lambda out: out["trainers"]["injected"]["params"])


def test_trainer_with_mesh_matches_single_process(suite, stacks, tmp_path):  # noqa: F811
    """The DP trainer (num_groups resolved to dp) samples what the
    one-process trainer at num_groups = dp samples, and updates alike."""
    _, tpipe = _pipelines(stacks, FNET)
    cfg = ttrain.TrainConfig(**TRAIN_FIELDS, num_groups=suite["dp"], output_dir=str(tmp_path),
                             ppo=tppo.PPOConfig(ppo_epochs=1, learning_rate=LR))
    single = ttrain.PPOTrainer(tpipe, make_reward_fn("image_psnr"), cfg)
    metrics = single.train_step(_batch())
    grads = {n: p.grad.numpy() for n, p in single.factor_net.named_parameters()}
    params = {n: p.detach().numpy() for n, p in single.factor_net.named_parameters()}
    for out in suite["ranks"]:
        t = out["trainers"]["sampled"]
        assert t["num_groups"] == suite["dp"]
        assert t["metrics"]["num_inference"] == metrics["num_inference"]
        for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward"):
            np.testing.assert_allclose(t["metrics"][name], metrics[name], err_msg=name,
                                       **LOSS_TOL)
        _assert_params_close(t["params"], grads, params, LR)
    _bit_equal_across_ranks(suite["ranks"], lambda out: out["trainers"]["sampled"]["params"])


def test_rank0_checkpoint_and_resume(suite):
    """The counterpart of tests/test_multihost.py:22: one checkpoint, written
    by rank 0, resumed bit-equal by every rank; the same per-step counts and
    parameter sums on every rank."""
    ckpts = os.listdir(suite["tmp"] / "sampled")
    assert ckpts == ["checkpoint-1"]
    first = suite["ranks"][0]["trainers"]
    for out in suite["ranks"]:
        t = out["trainers"]
        assert t["ckpt_exists"] and t["resumed"] and t["resumed_equal"]
        assert t["resumed_step"] == 1
        assert t["counts"] == first["counts"] and all(2 <= c < 4 for c in t["counts"])
        assert t["param_sum"] == first["param_sum"]


# ------------------------------------------------------------------- eval
def test_sharded_eval_matches_unsharded(suite):
    """The counterpart of tests/test_eval_and_config.py:183: 11 pairs, padded
    to the data ranks, scored, gathered and unpadded."""
    gen_dir, ref_dir = suite["pngs"]
    ref = tcons.evaluate_consistency(make_reward_fn("image_psnr"), gen_dir, ref_dir,
                                     batch_size=16, device="cpu")
    j_sharded = jcons.evaluate_consistency(jmetrics.image_psnr_reward, gen_dir, ref_dir,
                                           batch_size=16,
                                           mesh=jmesh.make_mesh(num_devices=suite["dp"]))
    for out in suite["ranks"]:
        stats = out["eval"]["psnr"]
        assert stats["num_scored"] == ref["num_scored"] == 11
        for name in ("mean", "median", "std", "min", "max"):
            np.testing.assert_allclose(stats[name], ref[name], rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(stats[name], j_sharded[name], rtol=1e-5, err_msg=name)


def test_sharded_eval_agrees_on_a_one_rank_failure(suite):
    """A reward that fails on one data rank's chunk only (an out-of-memory,
    say) sends every rank to the item-by-item fallback together: no rank
    hangs in the gather, and every pair is still scored."""
    gen_dir, ref_dir = suite["pngs"]
    ref = tcons.evaluate_consistency(make_reward_fn("image_psnr"), gen_dir, ref_dir,
                                     batch_size=16, device="cpu")
    for out in suite["ranks"]:
        stats = out["eval"]["one_rank_fault"]
        assert stats["num_scored"] == 11 and stats["num_errors"] == 0
        for name in ("mean", "median", "std", "min", "max"):
            np.testing.assert_allclose(stats[name], ref[name], rtol=1e-6, err_msg=name)


# ------------------------------------------------------------ mesh set-up
def test_hybrid_mesh_falls_back_on_one_node(suite):
    """The counterpart of tests/test_dist.py:179: on one node the hybrid mesh
    is the plain mesh of the same global shape, and drives a sharded sum."""
    n = suite["dp"]
    for out in suite["ranks"]:
        shape, total = out["config"]["hybrid"]
        assert shape == {"data": n // 2, "model": 2}
        assert total == float(np.arange(8.0).sum() * 2)


def test_hybrid_mesh_keeps_the_model_axis_in_a_node(suite):
    """A node grid that splits the model axis, or a model axis wider than a
    node's ranks, raises instead of laying the model groups across nodes."""
    for out in suite["ranks"]:
        assert out["config"]["hybrid_refused"] == [True, True]


def test_mesh_from_config_clamps(suite):
    """The counterpart of tests/test_dist.py:190: None for 1 x 1, the model
    axis honoured, too many shards clamped, a model axis that does not divide
    the world dropped, each with a warning."""
    n = suite["dp"]
    for out in suite["ranks"]:
        cfg = out["config"]
        assert cfg["1x1"]
        assert cfg["nx1"] == ({"data": n}, 0)
        assert cfg["half_x2"] == ({"data": n // 2, "model": 2}, 0)
        assert cfg["64x1"] == ({"data": n}, 1)
        assert cfg["nx3"] == ({"data": n}, 1)


def test_spawn_reports_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one fails"):
        launch.spawn(workers.fails_on_rank_one, 2, timeout_s=60)
