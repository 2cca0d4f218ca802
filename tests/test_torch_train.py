"""consolver_torch's PPOTrainer against the JAX package's on the tiny SD
stack (weights carried across by ``load_jax_params``), and its own
checkpointing.

One ``train_step`` on each side with the same batch.  The JAX trajectory is
captured by wrapping ``consolver_tpu.rl.ppo.flatten_trajectory``; its
actions are fed to the port's rollout by a test-only ``sample_action`` that
takes the mode at step 0 (dropped from the trajectory; with ``scaler_dim=0``
its action cannot move the latents, since the first step passes the single
history slot through) and the JAX actions at steps >= 1 with the port's own
probabilities of them.  The host draws (step count, group picks) are
bit-equal.  Tolerances (f32 on the CPU): the rollouts differ by the tiny
stack's 1e-5 per UNet call, so old probabilities hold 2e-4, rewards (PSNR,
dB) 2e-3 and the advantages, which divide by the group's reward spread,
2e-2 of the advantage scale; the loss and its aux follow the advantages
(2e-3).  Adam's first step moves each parameter by about ``lr`` times the
sign of its gradient, so parameters hold 1e-6 where the gradient is clear
of 0, and move by at most ``2 lr`` elsewhere (:func:`assert_params_close`).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tschedules
from consolver_torch.pipelines import t2i as tt2i
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TFConfig
from consolver_torch.rewards import metrics as tmetrics
from consolver_torch.rewards.registry import make_reward_fn
from consolver_torch.rl import ppo as tppo
from consolver_torch.rl import train as ttrain
from consolver_tpu.core import schedules
from consolver_tpu.pipelines import t2i as jt2i
from consolver_tpu.rewards import metrics as jmetrics
from consolver_tpu.rl import ppo as jppo
from consolver_tpu.rl import train as jtrain
from tests.test_torch_pipeline import _factor, stacks  # noqa: F401  (fixture)
from tests.torch_dist_workers import world1_mesh

FNET = dict(order_dim=4, scaler_dim=0, num_actions=11, family="sd")
PROB_TOL = dict(rtol=2e-4, atol=2e-4)
REWARD_TOL = dict(rtol=0, atol=2e-3)
LOSS_TOL = dict(rtol=2e-3, atol=2e-3)


def _pipelines(stacks, seed=7):  # noqa: F811
    (unet, up, te, tp, vae, vp), (tunet, tte, tvae) = stacks
    jnet, fparams, tnet = _factor(FNET, seed)
    jpipe = jt2i.TextToImagePipeline(unet, up, te, tp, vae, vp, schedules.DiffusionSchedule.sd15(),
                                     factor_net=jnet, factor_params=fparams)
    tpipe = tt2i.TextToImagePipeline(tunet, tte, tvae, tschedules.DiffusionSchedule.sd15(),
                                     factor_net=tnet, device="cpu")
    return jpipe, tpipe


def _configs(grad_accumulation_steps=1, **kwargs):
    ppo_kwargs = dict(ppo_epochs=1, learning_rate=1e-3,
                      grad_accumulation_steps=grad_accumulation_steps)
    fields = dict(min_inference_steps=2, max_inference_steps=4, seed=0, output_dir="unused")
    fields.update(kwargs)
    return (jtrain.TrainConfig(**fields, ppo=jppo.PPOConfig(**ppo_kwargs)),
            ttrain.TrainConfig(**fields, ppo=tppo.PPOConfig(**ppo_kwargs)))


def _batch(seed=0, rows=4):
    rng = np.random.default_rng(seed)
    return {
        "noise": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "latent": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "prompt_ids": rng.integers(1, 50, (rows, 4)).astype(np.int64),
    }


def _capture(monkeypatch, ppo_module, train_module, captured):
    """Wrap the trainer's flatten_trajectory and group repeat to record
    their inputs and outputs."""
    flatten, repeat = ppo_module.flatten_trajectory, train_module.repeat_random_sample_groups

    def flatten_and_record(traj, advantages):
        captured["traj"], captured["advantages"] = traj, np.asarray(advantages)
        out = flatten(traj, advantages)
        captured["old_probs"] = np.asarray(out[2])
        return out

    def repeat_and_record(batch, rng, num_groups):
        captured["batch"] = repeat(batch, rng, num_groups)
        return captured["batch"]

    monkeypatch.setattr(ppo_module, "flatten_trajectory", flatten_and_record)
    monkeypatch.setattr(train_module, "repeat_random_sample_groups", repeat_and_record)


def jax_psnr_recorded(captured):
    def reward(pred, target):
        r = jmetrics.image_psnr_reward(pred, target)
        jax.debug.callback(lambda x: captured.__setitem__("rewards", np.asarray(x)), r)
        return r

    return reward


def torch_psnr_recorded(captured):
    def reward(pred, target):
        r = tmetrics.image_psnr_reward(pred, target)
        captured["rewards"] = r.numpy().copy()
        return r

    return reward


def inject_actions(monkeypatch, net: TFactorNet, actions):
    """The port's policy replays ``actions`` ``[B, S-1, A]`` at steps >= 1
    (the mode at step 0, which the trajectory drops), with its own
    probabilities of them."""
    step = {"i": 0}

    def sample_action(conds, generator=None):
        i = step["i"]
        step["i"] = i + 1
        if i == 0:
            return net.mode_action(conds)
        chosen = torch.as_tensor(np.asarray(actions)[:, i - 1], device=conds["x"].device)
        probs, _ = net.get_action_probs(conds, chosen)
        return chosen, probs

    monkeypatch.setattr(net, "sample_action", sample_action)
    return step


def assert_params_close(tnet, jparams, lr):
    """Parameters after one Adam step (about ``lr * sign(g)``): equal where
    the gradient is clear of 0; an element whose gradient is below 1e-3 of
    its tensor's largest (the advantages, and so the gradients, differ by
    about 5e-4 between the packages) may take the other sign, moving it by
    up to ``2 lr``.  The port's ``.grad`` holds the step's gradient."""
    from consolver_torch.models.convert import load_jax_params

    want = load_jax_params(TFactorNet(tnet.config, device="cpu"), jparams).state_dict()
    for name, p in tnet.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        far = diff > 1e-6 + 1e-6 * np.abs(want[name].numpy())
        g = np.abs(p.grad.numpy())
        assert not (far & (g >= 1e-3 * g.max())).any(), name
        assert (diff <= 2 * lr * 1.01).all(), name


def _compare_steps(j, t, monkeypatch, batch):
    """Run one JAX train_step, then the port's with its actions injected;
    returns both captures and metrics."""
    (jtrainer, jcap), (ttrainer, tcap) = j, t
    j_metrics = jtrainer.train_step(dict(batch))
    jax.effects_barrier()
    steps = inject_actions(monkeypatch, ttrainer.factor_net, jcap["traj"].actions)
    t_metrics = ttrainer.train_step(dict(batch))
    assert steps["i"] == jcap["traj"].actions.shape[1] + 1
    assert t_metrics["num_inference"] == j_metrics["num_inference"]
    for k, v in jcap["batch"].items():
        np.testing.assert_array_equal(tcap["batch"][k], v)
    for name in ("conds_x", "actions", "masks"):
        np.testing.assert_array_equal(getattr(tcap["traj"], name).numpy(),
                                      np.asarray(getattr(jcap["traj"], name)), err_msg=name)
    np.testing.assert_allclose(tcap["old_probs"], jcap["old_probs"], **PROB_TOL)
    np.testing.assert_allclose(tcap["rewards"], jcap["rewards"], **REWARD_TOL)
    assert np.ptp(jcap["rewards"]) > 1e-3  # the rows' actions differ
    scale = jtrainer.config.ppo.advantage_scale
    np.testing.assert_allclose(tcap["advantages"], jcap["advantages"], rtol=0, atol=2e-2 * scale)
    for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward"):
        np.testing.assert_allclose(t_metrics[name], j_metrics[name], err_msg=name, **LOSS_TOL)
    return j_metrics, t_metrics


@pytest.mark.parametrize("padded", [False, True], ids=["per_count", "padded"])
def test_train_step_matches_jax(stacks, monkeypatch, padded):  # noqa: F811
    jpipe, tpipe = _pipelines(stacks)
    jcfg, tcfg = _configs(max_inference_steps=5 if padded else 4, padded_rollout=padded)
    jcap, tcap = {}, {}
    _capture(monkeypatch, jppo, jtrain, jcap)
    _capture(monkeypatch, tppo, ttrain, tcap)
    jtrainer = jtrain.PPOTrainer(jpipe, jax_psnr_recorded(jcap), jcfg)
    ttrainer = ttrain.PPOTrainer(tpipe, torch_psnr_recorded(tcap), tcfg)
    j_metrics, _ = _compare_steps((jtrainer, jcap), (ttrainer, tcap), monkeypatch, _batch())
    assert j_metrics["num_inference"] == 3 and ttrainer.global_step == 1
    if padded:  # 3 real steps of a 4-step program: the last row is a pad
        np.testing.assert_array_equal(tcap["traj"].valid[0].numpy(), [1, 1, 0])
    assert_params_close(ttrainer.factor_net, jtrainer.params, tcfg.ppo.learning_rate)


def test_rollout_records_no_graph_and_no_inference_tensors(stacks, monkeypatch):  # noqa: F811
    """The rollout runs under no_grad; the trajectory is made of normal
    tensors that the FactorNet's backward can save."""
    _, tpipe = _pipelines(stacks)
    _, tcfg = _configs()
    trainer = ttrain.PPOTrainer(tpipe, make_reward_fn("image_psnr"), tcfg)
    seen = {}
    _capture(monkeypatch, tppo, ttrain, seen)
    trainer.train_step(_batch())
    for name in ("conds_x", "actions", "probs", "masks"):
        tensor = getattr(seen["traj"], name)
        assert not tensor.requires_grad and not tensor.is_inference(), name
    assert all(p.grad is not None for p in trainer.factor_net.parameters())
    assert all(p.grad is None for p in tpipe.unet.parameters())


def _batches():
    """Index-dependent content: a misaligned stream after a resume changes
    the consumed data."""
    i = 0
    while True:
        yield _batch(seed=100 + i)
        i += 1


def _trainer(stacks, out, max_steps, ckpt_steps=100, limit=None, k=1):  # noqa: F811
    _, cfg = _configs(max_train_steps=max_steps, seed=7, output_dir=str(out),
                      checkpointing_steps=ckpt_steps, checkpoints_total_limit=limit,
                      grad_accumulation_steps=k)
    return ttrain.PPOTrainer(_pipelines(stacks)[1], make_reward_fn("image_psnr"), cfg)


def _state(trainer):
    opt = trainer.optimizer.adamw.state
    return ([p.detach().clone() for p in trainer.factor_net.parameters()]
            + [t.clone() for p in trainer.factor_net.parameters() for t in opt[p].values()])


@pytest.mark.parametrize("k", [1, 2])
def test_resume_replays_uninterrupted_run(stacks, tmp_path, k):  # noqa: F811
    """3 steps, checkpoint, a fresh trainer resumes to 6: the policy and the
    optimizer state are bit-equal to an uninterrupted 6-step run (with k = 2
    the accumulation buffer is mid-way at the checkpoint)."""
    def trainer(out, steps, ckpt=100):
        return _trainer(stacks, out, steps, ckpt, k=k)

    control = trainer(tmp_path / "a", 6)
    control.fit(_batches())
    victim = trainer(tmp_path / "b", 3, ckpt=3)
    victim.fit(_batches())
    assert victim.global_step == 3 and os.path.isdir(tmp_path / "b" / "checkpoint-3")
    resumed = trainer(tmp_path / "b", 6)
    assert resumed.resume_from_checkpoint("latest") and resumed.global_step == 3
    assert resumed.optimizer.mini_step == victim.optimizer.mini_step == 3 % k
    resumed.fit(_batches())
    assert resumed.global_step == 6
    for got, want in zip(_state(resumed), _state(control), strict=True):
        assert torch.equal(got, want)
    assert resumed.optimizer.mini_step == control.optimizer.mini_step
    for got, want in zip(resumed.optimizer.acc_grads, control.optimizer.acc_grads):
        assert torch.equal(got, want)


def test_fit_checkpoints_on_failure_and_interrupt(stacks, tmp_path):  # noqa: F811
    trainer = _trainer(stacks, tmp_path, 10)

    def batches(error):
        yield _batch()
        raise error

    with pytest.raises(RuntimeError, match="data source died"):
        trainer.fit(batches(RuntimeError("data source died")))
    assert trainer._checkpoint_dirs() == ["checkpoint-1"]
    again = _trainer(stacks, tmp_path, 10)
    assert again.resume_from_checkpoint("latest") and again.global_step == 1
    with pytest.raises(KeyboardInterrupt):
        again.fit(batches(KeyboardInterrupt()))  # the fast-forward skips the good batch
    assert again.global_step == 1 and trainer._checkpoint_dirs() == ["checkpoint-1"]
    assert not _trainer(stacks, tmp_path / "empty", 1).resume_from_checkpoint("latest")


def test_total_limit_prunes_by_step_number(stacks, tmp_path):  # noqa: F811
    for step in (9, 100, 10):  # by name, checkpoint-9 would sort last
        os.makedirs(tmp_path / "old" / f"checkpoint-{step}")
    trainer = _trainer(stacks, tmp_path / "old", 2, limit=2)
    trainer.global_step = 101
    trainer.save_checkpoint()
    assert trainer._checkpoint_dirs() == ["checkpoint-100", "checkpoint-101"]
    trainer = _trainer(stacks, tmp_path / "run", 3, ckpt_steps=1, limit=2)
    trainer.fit(_batches())
    assert sorted(os.listdir(tmp_path / "run")) == ["checkpoint-2", "checkpoint-3"]


def test_fit_logs_param_sum_every_tenth_interval(stacks, tmp_path, monkeypatch):  # noqa: F811
    trainer = _trainer(stacks, tmp_path, 20)
    trainer.config = dataclasses.replace(trainer.config, log_every=1)

    def fake_step(batch):
        trainer.global_step += 1
        return {"loss": 0.0}

    monkeypatch.setattr(trainer, "train_step", fake_step)
    logged = []
    trainer.fit(iter([{}] * 25), log_fn=lambda step, m: logged.append((step, dict(m))))
    assert [s for s, _ in logged] == list(range(1, 21))
    want = float(sum(p.detach().double().sum() for p in trainer.factor_net.parameters()))
    assert [s for s, m in logged if "param_sum" in m] == [10, 20]
    assert all(m["param_sum"] == want for s, m in logged if s % 10 == 0)


def test_save_pretrained_round_trips(stacks, tmp_path):  # noqa: F811
    trainer = _trainer(stacks, tmp_path, 1)
    path = trainer.save_pretrained(str(tmp_path / "final"))
    with open(tmp_path / "final" / "factor_net_config.json") as f:
        cfg = TFConfig(**json.load(f))
    assert cfg == trainer.factor_net.config
    net = TFactorNet(cfg, device="cpu")
    net.load_state_dict(torch.load(path, weights_only=True))
    for a, b in zip(net.parameters(), trainer.factor_net.parameters(), strict=True):
        assert torch.equal(a, b)


def test_mesh_and_missing_policy_raise(stacks):  # noqa: F811
    _, tpipe = _pipelines(stacks)
    _, cfg = _configs()
    with world1_mesh() as mesh:  # a mesh is accepted: one data-parallel rank
        trainer = ttrain.PPOTrainer(tpipe, make_reward_fn("image_psnr"), cfg, mesh=mesh)
        assert trainer.num_groups == 1 and trainer.grad_sync is not None
    tpipe.factor_net = None
    with pytest.raises(ValueError, match="factor_net"):
        ttrain.PPOTrainer(tpipe, make_reward_fn("image_psnr"), cfg)
