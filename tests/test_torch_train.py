"""The port's trainer (pitchvis_tpu_torch/train/train.py) against the JAX
package's (pitchvis_tpu/train/train.py) on the CPU: the data windows, the
loss, five optimizer steps of each schedule from the same weights on the
same batches with each step's gradients, the evaluation counts, the batches train() draws, and the
synthetic task of tests/test_ml.py learned, with its checkpoints.

Budgets: the loss within rtol 1e-6 on the same probabilities; over five
train_steps (dropout 0, lr 1e-5) the losses within rtol 1e-5 and every
parameter within atol 1e-6, a tenth of one step's largest move (Adam moves
a parameter by about lr a step; the gradients differ in the last bits, the
update's rounding in torch's and optax's formulas); each step's gradient,
leaf by leaf, within 1e-5 of that leaf's largest |gradient| of jax.grad's
(Adam's update hardly depends on the gradient's size, so the parameters
alone would pass a backward off by a constant factor); the learning-rate
schedule within 1e-6 of the peak rate of optax's (which computes the cosine
in f32, this one in float64)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pitchvis_tpu.train.train as jtrain
import pitchvis_tpu_torch.train.train as ttrain
from pitchvis_tpu_torch.convert import pitch_mlp_params_from_numpy

from test_ml import CFG as JAX_CFG
from test_ml import synthetic_dataset

CFG = ttrain.TrainConfig(**dataclasses.asdict(JAX_CFG))
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
GRAD_REL = 1e-5
STEP_LR = 1e-5


def test_configs_are_the_jax_trainers():
    """TrainConfig() keeps the reference's hyperparameters
    (train.py:108-146), and both configs equal the JAX trainer's."""
    cfg = ttrain.TrainConfig()
    assert cfg.schedule == "const" and cfg.learning_rate == 1e-5
    assert cfg.batch_size == 300 and cfg.eps == 1.1920929e-7
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jtrain.TrainConfig())
    assert dataclasses.asdict(ttrain.tuned_config(epochs=3)) == dataclasses.asdict(jtrain.tuned_config(epochs=3))


def test_window_data_matches_jax():
    data = synthetic_dataset(20)
    x, y = ttrain.window_data(data, CFG)
    jx, jy = jtrain.window_data(data, JAX_CFG)
    assert x.shape == (20 - CFG.t_window + 1, CFG.t_window * CFG.n_buckets) and y.shape == (18, 128)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError, match="not enough frames"):
        ttrain.window_data(synthetic_dataset(2), CFG)


def test_bce_loss_matches_jax():
    """Predictions 0, 1 and 1e-9 (clamped to [1e-7, 1 - 1e-7] before the
    log) and others, against both targets."""
    pred = np.array([[0.0, 1.0, 1e-9, 0.5, 0.9, 0.1, 1.0 - 1e-9, 0.3]], np.float32)
    for target in (np.ones_like(pred), np.zeros_like(pred), (np.arange(8) % 2)[None].astype(np.float32)):
        got = float(ttrain.bce_loss(torch.from_numpy(pred), torch.from_numpy(target)))
        want = float(jtrain.bce_loss(jnp.asarray(pred), jnp.asarray(target)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.isfinite(got)


@pytest.mark.parametrize("schedule", ["const", "warmup_cosine"])
def test_train_steps_match_optax(schedule):
    """Five steps from the JAX trainer's initial weights (converted) on the
    same batches of the synthetic task, dropout 0: the port's Adam with
    coupled decay ("const") and AdamW under the warmup-cosine LambdaLR
    against optax's chains. steps_hint 40 makes a 2-step warmup (the first
    update at lr 0, the second at half the peak), then the cosine. Each
    step's gradients (left on the parameters by train_step) against jax.grad
    of the JAX trainer's loss at the same weights and batch."""
    cfg = dataclasses.replace(CFG, dropout=0.0, learning_rate=STEP_LR, schedule=schedule, steps_hint=40)
    jcfg = jtrain.TrainConfig(**dataclasses.asdict(cfg))
    jm = jtrain.make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, cfg.t_window * cfg.n_buckets)))
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(jp)
    model = ttrain.make_model(cfg, device="cpu")
    model.load_state_dict(pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    optimizer, scheduler = ttrain.make_optimizer(cfg, model)
    x, y = ttrain.window_data(synthetic_dataset(200, seed=3), cfg)
    key = jax.random.PRNGKey(1)
    jgrad = jax.jit(jax.grad(
        lambda p, xb, yb: jtrain.bce_loss(jm.apply(p, xb, train=True, rngs={"dropout": key}), yb)))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for step in range(5):
        xb, yb = x[step * 32 : (step + 1) * 32], y[step * 32 : (step + 1) * 32]
        want_grad = pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jgrad(jp, xb, yb)), device="cpu")
        jp, opt_state, jloss = jtrain.train_step(jm, tx, jp, opt_state, jnp.asarray(xb), jnp.asarray(yb), key)
        loss = ttrain.train_step(model, optimizer, torch.from_numpy(xb), torch.from_numpy(yb), scheduler)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, err_msg=f"loss at step {step}")
        for k, p in model.named_parameters():
            scale = float(want_grad[k].abs().max())
            assert scale > 0, f"{k}: a zero gradient at step {step}"
            np.testing.assert_allclose(p.grad.numpy(), want_grad[k].numpy(), atol=GRAD_REL * scale, rtol=0,
                                       err_msg=f"{k}'s gradient at step {step}")
        want = pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{k} after step {step}")
    moved = max(float((v - start[k]).abs().max()) for k, v in model.state_dict().items())
    assert moved > 10 * PARAM_ATOL  # the steps moved the weights past the tolerance
    if schedule == "warmup_cosine":
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(optax.warmup_cosine_decay_schedule(
            0.0, STEP_LR, 2, 40)(5)), rel=1e-6)


def test_lr_schedule_matches_optax():
    cfg = dataclasses.replace(ttrain.tuned_config(), steps_hint=100)
    sched = ttrain.lr_schedule(cfg)
    want = optax.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, 5, 100)
    for t in range(0, 110):
        np.testing.assert_allclose(sched(t), float(want(t)), rtol=0, atol=1e-6 * cfg.learning_rate,
                                   err_msg=f"step {t}")
    assert sched(0) == 0.0 and sched(5) == cfg.learning_rate and sched(100) == 0.0
    assert ttrain.lr_schedule(ttrain.TrainConfig())(123) == 1e-5
    with pytest.raises(ValueError, match="positive decay_steps"):
        ttrain.lr_schedule(dataclasses.replace(cfg, steps_hint=1))


def test_eval_step_counts_match_jax():
    """The same weights on the same windows give the same tp/fp/fn/correct
    counts and size (a middling model, so that every count is nonzero)."""
    jm = jtrain.make_model(JAX_CFG)
    jp = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, CFG.t_window * CFG.n_buckets)))
    model = ttrain.make_model(CFG, device="cpu")
    model.load_state_dict(pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    x, y = ttrain.window_data(synthetic_dataset(60, seed=4), CFG)
    y[:, :64] = 1.0  # labels where the random model says yes too
    got = ttrain.eval_step(model, torch.from_numpy(x), torch.from_numpy(y))
    want = jtrain.eval_step(jm, jp, jnp.asarray(x), jnp.asarray(y))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert all(int(v) > 0 for v in got)


def test_train_draws_the_jax_trainers_batches(monkeypatch):
    """train() splits and shuffles with the JAX trainer's NumPy calls, so
    both see the same batches in the same order (final partial batch
    included)."""
    seen = {"jax": [], "torch": []}
    j_step, t_step = jtrain.train_step, ttrain.train_step

    def j_record(model, tx, params, opt_state, x, y, key):
        seen["jax"].append(np.asarray(x).copy())
        return j_step(model, tx, params, opt_state, x, y, key)

    def t_record(model, optimizer, x, y, scheduler=None, generator=None):
        seen["torch"].append(x.numpy().copy())
        return t_step(model, optimizer, x, y, scheduler, generator)

    monkeypatch.setattr(jtrain, "train_step", j_record)
    monkeypatch.setattr(ttrain, "train_step", t_record)
    data = synthetic_dataset(90, seed=5)
    cfg = dataclasses.replace(CFG, epochs=2, batch_size=25)
    jtrain.train(data, jtrain.TrainConfig(**dataclasses.asdict(cfg)))
    ttrain.train(data, cfg, device="cpu")
    assert len(seen["torch"]) == len(seen["jax"]) == 2 * 3  # 70 windows: 25, 25, 20
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


def test_training_learns_synthetic_task(tmp_path):
    """tests/test_ml.py's task: micro-F1 > 0.6 and accuracy > 0.99; the
    checkpoint restores the same outputs."""
    data = synthetic_dataset()
    params, metrics = ttrain.train(data, CFG, checkpoint_dir=str(tmp_path), device="cpu")
    assert metrics["f1_micro"] > 0.6
    assert metrics["accuracy"] > 0.99
    assert metrics["steps"] == CFG.epochs * -(-320 // CFG.batch_size)
    restored = ttrain.load_checkpoint(str(tmp_path), CFG, device="cpu")
    model = ttrain.make_model(CFG, device="cpu")
    x, _ = ttrain.window_data(data, CFG)
    with torch.no_grad():
        a = torch.func.functional_call(model, params, (torch.from_numpy(x[:4]),))
        b = torch.func.functional_call(model, restored, (torch.from_numpy(x[:4]),))
    assert torch.equal(a, b)
    with open(tmp_path / "train_meta.json") as f:
        meta = json.load(f)
    assert set(meta) == {"config", "metrics"} and meta["config"]["steps_hint"] == metrics["steps"]


def test_tuned_recipe_learns():
    cfg = ttrain.tuned_config(n_buckets=48, t_window=3, mlp_size=64, mlp_layers=2, epochs=10, batch_size=32,
                              learning_rate=2e-3)
    _, metrics = ttrain.train(synthetic_dataset(), cfg, device="cpu")
    assert metrics["f1_micro"] > 0.6


def test_small_dataset_still_trains():
    """n_train < batch_size still runs one (partial) batch an epoch."""
    cfg = dataclasses.replace(CFG, batch_size=100_000, epochs=3)
    _, metrics = ttrain.train(synthetic_dataset(), cfg, device="cpu")
    assert metrics["steps"] == 3 and len(metrics["epoch_loss"]) == 3
    assert metrics["epoch_loss"][-1] < metrics["epoch_loss"][0]


def test_checkpoint_saves_do_not_collide(tmp_path):
    """Two saves into one directory within a second both land; the newest
    (numeric order) restores; staging files and other names are skipped;
    an empty directory raises."""
    with pytest.raises(FileNotFoundError):
        ttrain.load_checkpoint(str(tmp_path), CFG, device="cpu")
    cfg = dataclasses.replace(CFG, epochs=1)
    first, _ = ttrain.train(synthetic_dataset(), cfg, checkpoint_dir=str(tmp_path), device="cpu")
    second, _ = ttrain.train(synthetic_dataset(), dataclasses.replace(cfg, seed=1), checkpoint_dir=str(tmp_path),
                             device="cpu")
    models = sorted(d for d in os.listdir(tmp_path) if d.startswith("model_"))
    assert len(models) == 2
    # strays: a staging file with a later stamp, a non-numeric name
    (tmp_path / "model_99999999999999999999.npz-tmp").write_bytes(b"partial")
    (tmp_path / "model_best.npz").write_bytes(b"not a checkpoint")
    # a second-stamped name sorts below the nanosecond ones as a number,
    # above them as a string
    np.savez(tmp_path / "model_9.npz", **{k: v.numpy() for k, v in first.items()})
    restored = ttrain.load_checkpoint(str(tmp_path), cfg, device="cpu")
    assert all(torch.equal(restored[k], second[k]) for k in second)
